"""The port's route and size decisions (shotgun_tpu_torch.routes): off a
card each equals the JAX package's (read from it where it is a name,
compared by behavior where it is a literal inside a JAX function), and the
H100's as pure functions of the card's total memory and of the processes
that share it: the budget, the device-build window, the auto crossover
and the auto batch, each where its caller reads it.  Then the probe's slot
limit on every device: past it 'auto' takes the sort join and an explicit
hash table raises before any table is made."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from shotgun_tpu import cli as jax_cli
from shotgun_tpu.aligner import _auto_batch as jax_auto_batch
from shotgun_tpu.index import device_build as jdb
from shotgun_tpu.reference import KmerReference as JaxKmerReference
from shotgun_tpu_torch import cli, routes
from shotgun_tpu_torch import reference as treference
from shotgun_tpu_torch.index import device_build as tdb
from shotgun_tpu_torch.index import hashtable as tht
from shotgun_tpu_torch.io.data_file import FASTAFile
from shotgun_tpu_torch.ops import probe as tprobe
from shotgun_tpu_torch.ops.probe_sort import SortedTableDev
from shotgun_tpu_torch.reference import KmerReference, _DeviceIndexStub
from shotgun_tpu_torch.routes import JAX_ROUTES, card_routes, device_routes

torch.set_num_threads(2)
CPU = torch.device("cpu")
#: ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
#: 80GB HBM3
H100_BYTES = 85_017_493_504
CORPUS_FA = "tests/golden/data/corpus.fa"
GATE_ENV = ("SHOTGUN_TPU_PROBE", "SHOTGUN_TPU_DEVICE_BUILD", "SHOTGUN_TPU_DEVICE_BUILD_MIN",
            "SHOTGUN_TPU_DEVICE_BUILD_MAX", tdb.HBM_BUDGET_ENV)


@pytest.fixture(autouse=True)
def _no_route_env(monkeypatch):
    for name in GATE_ENV:
        monkeypatch.delenv(name, raising=False)


def _on_card(monkeypatch, module, procs: int = 1):
    """``module``'s ``device_routes`` made the H100's, whatever the device."""
    monkeypatch.setattr(module, "device_routes",
                        lambda device: card_routes(H100_BYTES, procs))


# ---------------------------------------------------------------------------
# off the card: the JAX package's values
# ---------------------------------------------------------------------------

def test_off_the_card_every_value_is_the_jax_packages():
    assert device_routes(CPU) == device_routes("cpu") == JAX_ROUTES
    assert JAX_ROUTES.auto_hash_min_keys == JaxKmerReference.AUTO_HASH_MIN_KEYS
    assert tdb.HBM_BUDGET_DEFAULT == JAX_ROUTES.hash_budget


@pytest.mark.parametrize("reads", [0, 1, 2047, 131_071, 131_072, 524_288, 10 ** 7])
def test_off_the_card_auto_batch_is_the_jax_packages(reads):
    assert device_routes(CPU).auto_batch(reads) == jax_auto_batch(reads)


def _device_build_rows(num_windows: int) -> dict:
    """A device build's products of 5 distinct keys standing for a genome
    of ``num_windows`` windows: the budget term counts the windows."""
    keys = torch.tensor([3, 9, 40, 77, 1000], dtype=torch.int64)
    return dict(keys=keys, sid=torch.zeros(5, dtype=torch.int32),
                gc=torch.ones(5, dtype=torch.int32), num_kmers=5, num_windows=num_windows)


def test_off_the_card_device_build_budget_behaves_as_jax(monkeypatch):
    """The JAX package's 10 GB literal, by behavior: at the largest window
    count its check admits, both packages assemble; one window more, both
    refuse (JAX's assembly stubbed: only its check runs)."""
    u = 5
    nb = 1 << max(int(max(u / tdb.HASH_LAMBDA, 1)) - 1, 1).bit_length()
    admitted = (JAX_ROUTES.hash_budget - nb * tdb.HASH_SLOTS * 16) // 32
    monkeypatch.setattr(jdb, "_hash_table_from_rows", lambda *a, **kw: ("table", "stash", 0))
    for n, fits in ((admitted, True), (admitted + 1, False)):
        jbuilt = {"num_kmers": u, "klo": np.broadcast_to(np.uint32(0), (n,)),
                  "khi": None, "sid": None, "gc": None}
        assert (jdb.device_hash_table(jbuilt) is not None) == fits
        assert (tdb.device_hash_table(_device_build_rows(n)) is not None) == fits


def _index(num_kmers: int, num_sets: int = 1) -> SimpleNamespace:
    return SimpleNamespace(num_kmers=num_kmers, num_sets=num_sets)


def _largest_admitted_index(budget: int, slots: int) -> int:
    """The most keys whose table term ``budget`` admits (bisection)."""
    lo, hi = 1, 1 << 40
    while lo < hi:
        mid = (lo + hi + 1) // 2
        term = tdb.index_table_bytes(mid, 1, slots, tdb._first_buckets(mid, slots))
        lo, hi = (mid, hi) if term <= budget else (lo, mid - 1)
    return lo


@pytest.mark.parametrize("slots", [4, 16])
def test_host_index_budget_off_the_card_is_ten_gb(slots):
    u = _largest_admitted_index(JAX_ROUTES.hash_budget, slots)
    assert tdb.index_table_admitted(_index(u), slots, CPU)
    assert not tdb.index_table_admitted(_index(u + 1), slots, CPU)


class _Routed(Exception):
    pass


def _fake_parse(monkeypatch, module, size: int):
    """``module``'s FASTA parse giving a container of ``size`` bases (no
    memory held), and its builds raising the route they were given."""
    genomes = SimpleNamespace(codes=np.broadcast_to(np.uint8(0), (size,)))
    container = SimpleNamespace(to_genome_arrays=lambda: genomes)
    monkeypatch.setattr(module, "FASTAFile", lambda path: SimpleNamespace(container=container))

    def device(*args, **kwargs):
        raise _Routed("device")

    def host(*args, **kwargs):
        raise _Routed("host")

    return device, host


def _port_route(monkeypatch, size: int, device=CPU) -> str:
    dev, host = _fake_parse(monkeypatch, cli, size)
    monkeypatch.setattr(cli.KmerReference, "from_device_build", dev)
    monkeypatch.setattr(cli, "create_reference", host)
    with pytest.raises(_Routed) as routed:
        cli.dumpalign_reference("g.fa", 31, False, 0.95, device)
    return str(routed.value)


def _jax_route(monkeypatch, size: int) -> str:
    dev, host = _fake_parse(monkeypatch, jax_cli, size)
    monkeypatch.setattr(jax_cli, "KmerReference",
                        type("Ref", (), {"from_device_build": staticmethod(dev),
                                         "__init__": lambda self, *a, **kw: host()}))
    with pytest.raises(_Routed) as routed:
        jax_cli.build_reference_align_and_dump("g.fa", 31, "r.fq", 1, 1, None, None, None)
    return str(routed.value)


@pytest.mark.parametrize("size", [3_999_999, 4_000_000, 64_000_000, 64_000_001])
def test_off_the_card_device_build_window_routes_as_jax(size, monkeypatch):
    want = "device" if 4_000_000 <= size <= 64_000_000 else "host"
    assert _jax_route(monkeypatch, size) == want
    assert _port_route(monkeypatch, size) == want


def _stub_reference(num_kmers: int, k: int = 31) -> KmerReference:
    return KmerReference(k, _index=_DeviceIndexStub(k, ["g"], np.ones(1, np.int64),
                                                    num_kmers, 1), device=CPU)


@pytest.mark.parametrize("keys", [JAX_ROUTES.auto_hash_min_keys, JAX_ROUTES.auto_hash_min_keys + 1])
def test_off_the_card_crossover_is_the_jax_packages(keys):
    want = "hash16" if keys > JaxKmerReference.AUTO_HASH_MIN_KEYS else "sort"
    assert _stub_reference(keys).probe_method() == want


def test_a_set_crossover_overrides_the_devices(monkeypatch):
    monkeypatch.setattr(KmerReference, "AUTO_HASH_MIN_KEYS", 100)
    assert _stub_reference(101).probe_method() == "hash16"
    assert _stub_reference(100).probe_method() == "sort"


# ---------------------------------------------------------------------------
# on the card: the H100's values
# ---------------------------------------------------------------------------

def _devbuild_term(mbp: int) -> int:
    """``device_hash_table``'s term for random genomes of ``mbp`` Mbp (about
    one distinct key a window)."""
    u = mbp * 1_000_000
    return tdb._first_buckets(u, 16) * 16 * 16 + 32 * u


BESIDE = routes.ROW_BYTES_PER_BASE * routes.CARD_DEVICE_BUILD_MAX + routes.STREAM_BYTES


def test_card_budget_is_half_the_card_less_the_rows_and_the_stream():
    one = card_routes(H100_BYTES)
    assert one.hash_budget == H100_BYTES // routes.RESERVED_PER_ALLOCATED - BESIDE
    # the largest device build the window admits takes hash16 at `auto`
    assert _devbuild_term(routes.CARD_DEVICE_BUILD_MAX // 1_000_000) <= one.hash_budget
    assert one.hash_budget > JAX_ROUTES.hash_budget


@pytest.mark.parametrize("procs", [1, 2, 3, 4])
def test_card_budget_splits_among_the_processes_on_a_card(procs):
    """Each process's budget and what sits beside it, reserved at the
    measured ratio, summed over the processes fits the card."""
    each = card_routes(H100_BYTES, procs).hash_budget
    assert each > 0
    assert procs * routes.RESERVED_PER_ALLOCATED * (each + BESIDE) <= H100_BYTES
    assert procs * routes.RESERVED_PER_ALLOCATED * (each + 1 + BESIDE) > H100_BYTES


def test_card_budget_admits_the_100m_key_tables(monkeypatch):
    """At 100M keys (2^25 buckets) a device build's term and a loaded
    index's both fit the card's budget of one process, and of two."""
    for procs in (1, 2):
        budget = card_routes(H100_BYTES, procs).hash_budget
        assert _devbuild_term(100) <= budget
        assert tdb.index_table_bytes(100_000_000, 1, 16, 1 << 25) <= budget


def test_card_budget_is_the_default_on_a_card_and_the_variable_overrides_it(monkeypatch):
    _on_card(monkeypatch, tdb)
    budget = card_routes(H100_BYTES).hash_budget
    assert tdb._budget(CPU) == budget
    u = _largest_admitted_index(budget, 16)
    assert tdb.index_table_admitted(_index(u), 16, CPU)
    assert not tdb.index_table_admitted(_index(u + 1), 16, CPU)
    monkeypatch.setenv(tdb.HBM_BUDGET_ENV, "1000")
    assert tdb._budget(CPU) == 1000
    assert not tdb.index_table_admitted(_index(u), 16, CPU)


def test_card_budget_refusal_still_takes_the_sort_join(monkeypatch):
    """The hash16 failure memo: a device build whose table the card's
    budget refuses keeps 'auto' on the sort join."""
    _on_card(monkeypatch, tdb)
    _on_card(monkeypatch, treference)
    built = _device_build_rows(card_routes(H100_BYTES).hash_budget // 32)
    assert tdb.device_hash_table(built) is None
    ref = _stub_reference(routes.CARD_AUTO_HASH_MIN_KEYS + 1)
    ref._built = built
    assert ref.probe_method() == "hash16"
    ref.device_probe_tables(CPU)
    assert ref._hash16_failed and ref.probe_method() == "sort"


@pytest.mark.parametrize("procs,world,devices,card", [
    (1, 1, 1, 0), (2, 2, 1, 0), (1, 4, 4, 3), (2, 3, 2, 0), (1, 3, 2, 1)])
def test_processes_on_a_card(procs, world, devices, card, monkeypatch):
    monkeypatch.setattr(routes.dist, "is_initialized", lambda: world > 1)
    monkeypatch.setattr(routes.dist, "get_world_size", lambda: world)
    monkeypatch.setattr(routes.torch.cuda, "device_count", lambda: devices)
    assert routes.procs_per_card(card) == procs


def test_device_routes_on_cuda_reads_the_card(monkeypatch):
    monkeypatch.setattr(routes.torch.cuda, "get_device_properties",
                        lambda card: SimpleNamespace(total_memory=H100_BYTES))
    monkeypatch.setattr(routes, "procs_per_card", lambda card: 2)
    assert device_routes(torch.device("cuda", 0)) == card_routes(H100_BYTES, 2)


@pytest.mark.parametrize("offset", [-1, 0, 1])
@pytest.mark.parametrize("edge", ["min", "max"])
def test_card_device_build_window(edge, offset, monkeypatch):
    _on_card(monkeypatch, cli)
    lo, hi = routes.CARD_DEVICE_BUILD_MIN, routes.CARD_DEVICE_BUILD_MAX
    size = (lo if edge == "min" else hi) + offset
    assert cli._device_build_window(CPU) == (lo, hi)
    assert _port_route(monkeypatch, size) == ("device" if lo <= size <= hi else "host")


def test_card_window_holds_the_sizes_run_through_the_cli_on_the_card():
    """The device build's window on the card reaches past the JAX package's
    64 Mbp ceiling to the 100 and 200 Mbp runs, and starts at the 4 Mbp
    from which the card's device route was no slower."""
    r = card_routes(H100_BYTES)
    assert r.device_build_min == 4_000_000
    assert r.device_build_max >= 200_000_000 > 100_000_000 > JAX_ROUTES.device_build_max


def test_card_window_variables_override(monkeypatch):
    _on_card(monkeypatch, cli)
    monkeypatch.setenv("SHOTGUN_TPU_DEVICE_BUILD_MAX", "1000")
    assert cli._device_build_window(CPU) == (routes.CARD_DEVICE_BUILD_MIN, 1000)
    monkeypatch.setenv("SHOTGUN_TPU_DEVICE_BUILD_MAX", "x")
    assert cli._device_build_window(CPU) == (routes.CARD_DEVICE_BUILD_MIN,
                                             routes.CARD_DEVICE_BUILD_MAX)


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_card_crossover(delta, monkeypatch):
    _on_card(monkeypatch, treference)
    keys = routes.CARD_AUTO_HASH_MIN_KEYS + delta
    assert _stub_reference(keys).probe_method() == ("hash16" if delta > 0 else "sort")
    assert _stub_reference(keys).probe_method("sort") == "sort"
    assert _stub_reference(keys, k=35).probe_method() == "sort"


@pytest.mark.parametrize("reads", [1, 10_000, 131_071, 131_072, 10 ** 7])
def test_card_auto_batch_is_one_batch_for_every_input(reads):
    assert card_routes(H100_BYTES).auto_batch(reads) == routes.CARD_BATCH == 65536


# ---------------------------------------------------------------------------
# the sweeps' tools, on the CPU at small size
# ---------------------------------------------------------------------------

def test_bench_sortjoin_prices_each_route_with_its_table(capsys):
    from shotgun_tpu_torch.tools import bench_sortjoin

    res = bench_sortjoin.main(["--device", "cpu", "--keys", "3000", "--batch", "16",
                               "--iters", "1"])
    capsys.readouterr()
    (run,) = res["runs"]
    made, ms, n = run["assembly_s"], run["ms"], run["run_batches"]
    assert n == bench_sortjoin.RUN_READS // 16
    assert set(made) == {"device_hash_table", "index_hash_table", "sorted_table"}
    assert all(v >= 0 for v in made.values())
    assert run["run_ms"] == {
        "device build, sort": n * ms["join"],
        "device build, hash16": n * ms["hash16"] + 1e3 * made["device_hash_table"],
        "host index, sort": n * ms["join"] + 1e3 * made["sorted_table"],
        "host index, hash16": n * ms["hash16"] + 1e3 * made["index_hash_table"]}


def test_bench_sortjoin_host_index_makes_the_tables_of_the_rows():
    """The host index that prices a host index's tables holds the
    benchmark's rows: its sort table is theirs, and its 16-slot table
    equals the device build's of the same rows."""
    from shotgun_tpu_torch.ops.probe_sort import sorted_table, sorted_table_host
    from shotgun_tpu_torch.tools import bench_sortjoin

    tab, _, _ = bench_sortjoin.make_case(np.random.default_rng(4), 2000, 8, CPU)
    index = bench_sortjoin.host_index(tab)
    got = sorted_table(*sorted_table_host(index), CPU)
    for a, b in zip(got, tab):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    (tkeys,) = tab.words
    dev = tdb.device_hash_table(dict(keys=tkeys, sid=tab.sid, gc=tab.gc, num_kmers=2000,
                                     num_windows=2000))
    host = tdb.index_hash_table(index, 16, CPU)
    assert torch.equal(dev[0], host[0]) and torch.equal(dev[1], host[1])


def test_profile_align_batches_measures_each_batch(capsys):
    from shotgun_tpu_torch.tools import profile_align

    res = profile_align.main(["--device", "cpu", "--genomes", "3", "--genome-len", "4000",
                              "--reads", "300", "--repeats", "1", "--batches", "64", "256"])
    capsys.readouterr()
    assert list(res["by_batch"]) == [64, 256]
    for r in res["by_batch"].values():
        assert r["reads"] == 300 and r["stream_reads_per_s"] > 0
        assert r["peak_allocated_bytes"] is None and r["idle_share"] is None
    assert "stream_reads_per_s" not in res and sum(res["statistics"].values()) == 300


#: the ``--profile`` stages that run inside another stage
NESTED_STAGES = {"hash_table_device", "db_host_prep", "fill", "fill_wait", "stage",
                 "enqueue", "validate", "carry_fetch", "host_merge", "sort_join_device"}


def test_profile_devbuild_cli_times_both_builds(monkeypatch):
    """``--cli``: the CLI's dumpalign -g in children on the host and the
    device build (each route's stage checked, the summaries equal)."""
    from shotgun_tpu_torch.tools import profile_devbuild

    monkeypatch.setattr(profile_devbuild, "CLI_READS", 256)
    res = profile_devbuild.cli_walls(0.01, CPU, log=lambda _: None)
    assert [r["route"] for r in res["runs"]] == list(profile_devbuild.CLI_ORDER)
    for r in res["runs"]:
        build = "db_build_device" if r["route"] == "device" else "db_build"
        assert build in r["stages"] and r["wall_s"] > 0
    for route in ("host", "device"):
        sums = [sum(r["stages"][n] for n in r["stages"] if n not in NESTED_STAGES)
                for r in res["runs"] if r["route"] == route]
        assert len(sums) == 2  # the median of two runs is their mean
        assert res[route]["stages_s"] == pytest.approx(sum(sums) / 2)
        assert res[route]["stages_spread_s"] == pytest.approx(max(sums) - min(sums))


def test_profile_devbuild_build_cost_prices_both_routes(monkeypatch):
    """``--build-cost``: each size's routes by the medians of their calls,
    the device route's one-time cost (its first call less its median at
    the smallest size) charged to every size, and the least size from
    which that sum is no slower than the host route."""
    from shotgun_tpu_torch.tools import profile_devbuild

    monkeypatch.setattr(profile_devbuild, "COST_ITERS", 3)
    monkeypatch.setattr(profile_devbuild, "COST_READS", 64)
    res = profile_devbuild.build_cost([0.02, 0.01], CPU, log=lambda _: None)
    first, second = res["sizes"]
    assert (first["mbp"], second["mbp"]) == (0.01, 0.02)
    assert res["once_s"] == pytest.approx(res["cold_s"] - first["device_s"])
    for size in res["sizes"]:
        for route in ("host", "device"):
            runs = size["runs"][route]
            assert len(runs) == 3 and size[f"{route}_s"] == sorted(runs)[1]
            assert size[f"{route}_spread_s"] == max(runs) - min(runs)
        assert size["device_once_s"] == pytest.approx(size["device_s"] + res["once_s"])
    ok = [s["device_once_s"] <= s["host_s"] for s in res["sizes"]]
    want = 0.01 if all(ok) else 0.02 if ok[1] else None
    assert res["device_no_slower_from_mbp"] == want


# ---------------------------------------------------------------------------
# the probe's slot limit, on every device
# ---------------------------------------------------------------------------

SLOT_LIMIT = 0x7FFF0000


def test_slot_limit_is_where_the_first_tables_pass_it():
    """``slot_limit_keys`` is the last key count whose first table, of
    ``_next_pow2(u / 4)`` buckets of 16 slots or ``_next_pow2(4u)`` of 4,
    has at most 0x7FFF0000 slots (the stash's first position): 268,435,459
    and 67,108,864 keys."""
    assert tht.STASH_POS_BASE == SLOT_LIMIT == tprobe.STASH_POS_BASE
    for slots, sized in ((16, lambda u: tht._next_pow2(int(u / 4)) * 16),
                         (4, lambda u: tht._next_pow2(4 * u) * 4)):
        u = tht.slot_limit_keys(slots)
        assert sized(u) <= SLOT_LIMIT < sized(u + 1)
        assert tdb._first_buckets(u, slots) * slots == sized(u)
        assert tht.slots_fit(tht.first_buckets(u, slots), slots)
        assert not tht.slots_fit(tht.first_buckets(u + 1, slots), slots)
    assert (tht.slot_limit_keys(16), tht.slot_limit_keys(4)) == (268_435_459, 67_108_864)


class _Counted:
    """A host index that reports ``num_kmers`` keys and is otherwise
    ``index``."""

    def __init__(self, index, num_kmers: int) -> None:
        self._index, self.num_kmers = index, num_kmers

    def __getattr__(self, name):
        return getattr(self._index, name)


def _counted_reference(num_kmers: int) -> KmerReference:
    """The golden corpus's k = 11 host index, reporting ``num_kmers``."""
    ref = KmerReference(11, FASTAFile(CORPUS_FA).container, device=CPU)
    ref.index = _Counted(ref.index, num_kmers)
    return ref


def _no_table_made(monkeypatch) -> None:
    """Every hash table maker raises if it is called."""
    def made(*args, **kwargs):
        raise AssertionError("a hash table was made")

    for module, name in ((treference, "index_hash_table"), (treference, "build_probe_table"),
                         (treference, "device_hash_table")):
        monkeypatch.setattr(module, name, made)


@pytest.mark.parametrize("card", [False, True])
def test_auto_takes_the_sort_join_past_the_slot_limit(card, monkeypatch):
    """A host index whose 16-slot table would pass the slot limit takes the
    sort join at 'auto', on the CPU's routes and the card's, and its probe
    table is the sort table, made without a hash table; at the limit
    'auto' still takes hash16."""
    if card:
        _on_card(monkeypatch, tdb)
        _on_card(monkeypatch, treference)
    limit = tht.slot_limit_keys(16)
    assert _counted_reference(limit).probe_method() == "hash16"
    ref = _counted_reference(limit + 1)
    assert ref.probe_method() == "sort"
    _no_table_made(monkeypatch)
    tab = ref.device_probe_tables(CPU)
    assert isinstance(tab, SortedTableDev) and list(ref._device_tables) == [("sort", "cpu")]
    assert ref.probe_method() == "sort"


@pytest.mark.parametrize("method,slots", [("hash16", 16), ("hash", 4), ("other", 4)])
def test_explicit_hash_past_the_slot_limit_raises_before_any_table(method, slots,
                                                                   monkeypatch):
    """An explicit 'hash16' past 268,435,459 keys, or 'hash' (any value but
    'sort' and 'hash16') past 67,108,864, raises ValueError naming the slot
    limit and SHOTGUN_TPU_PROBE=sort before any table exists; one key fewer
    keeps the route."""
    limit = tht.slot_limit_keys(slots)
    want = "hash16" if method == "hash16" else "hash"
    assert _counted_reference(limit).probe_method(method) == want
    ref = _counted_reference(limit + 1)
    _no_table_made(monkeypatch)
    with pytest.raises(ValueError, match="SHOTGUN_TPU_PROBE=sort") as err:
        ref.device_probe_tables(CPU, method)
    assert isinstance(err.value, tht.SlotLimitError) and "0x7fff0000" in str(err.value)
    monkeypatch.setenv("SHOTGUN_TPU_PROBE", method)
    with pytest.raises(ValueError, match="slots"):
        ref.probe_method()
    assert ref._device_tables == {} and ref._probe_tables == {}


def test_a_doubling_past_the_slot_limit_takes_the_sort_join_at_auto(monkeypatch):
    """When a stash doubling would take a host index's table past the slot
    limit (here a limit lowered to the first table's slots), both table
    makers raise SlotLimitError; 'auto' then takes the sort join from then
    on, and an explicit 'hash16' raises it."""
    ref = KmerReference(11, FASTAFile(CORPUS_FA).container, device=CPU)
    monkeypatch.setattr(KmerReference, "AUTO_HASH_MIN_KEYS", 0)
    nb = tht.first_buckets(ref.index.num_kmers, 16)
    monkeypatch.setattr(tht, "STASH_POS_BASE", nb * 16)
    assert ref.probe_method() == "hash16"
    idx = ref.index
    with pytest.raises(tht.SlotLimitError):
        tht.build_probe_table(idx.kmer_lo, idx.kmer_hi, idx.set_id, idx.genome_counts(),
                              slots_per_bucket=16, stash_cap=-1)
    monkeypatch.setattr(tdb, "_place", lambda *args: None)  # every stash overflows
    with pytest.raises(tht.SlotLimitError):
        tdb.index_hash_table(idx, 16, CPU)
    with pytest.raises(tht.SlotLimitError):
        ref.device_probe_tables(CPU, "hash16")
    assert isinstance(ref.device_probe_tables(CPU), SortedTableDev)
    assert ref._hash16_failed and ref.probe_method() == "sort"
    assert list(ref._device_tables) == [("sort", "cpu")]


def test_a_device_build_past_the_slot_limit_takes_the_sort_join(monkeypatch):
    """A device build whose 16-slot table would pass the slot limit (the
    budget raised so it would admit it) is not assembled: 'auto' keeps the
    sort join; an explicit 'hash16' of that many keys raises first."""
    monkeypatch.setenv(tdb.HBM_BUDGET_ENV, str(1 << 50))
    built = _device_build_rows(5)
    monkeypatch.setattr(tdb, "_first_buckets", lambda u, slots: (SLOT_LIMIT // 16) + 1)
    assert tdb.device_hash_table(built) is None
    ref = _stub_reference(tht.slot_limit_keys(16) + 1)
    assert ref.probe_method() == "sort"
    with pytest.raises(tht.SlotLimitError):
        ref.probe_method("hash16")
