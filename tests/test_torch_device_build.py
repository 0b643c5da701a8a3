"""The port's device build (shotgun_tpu_torch.index.device_build) against
the host index and the JAX package's device build: equal distinct keys,
genome counts and set membership per key; the same rejections; the
device-assembled 16-slot table; and equal dumpalign summaries from
device-built and host-built references."""

import numpy as np
import pytest
import torch

from shotgun_tpu.aligner import PseudoAlignment as JaxPseudoAlignment
from shotgun_tpu.index.build import build_index
from shotgun_tpu.index.device_build import device_build_tables as jax_device_build
from shotgun_tpu.io.data_file import FASTAQFile, open_fastq_stream
from shotgun_tpu.io.packing import pack_genomes
from shotgun_tpu.io.records import SeqRecord
from shotgun_tpu.reference import KmerReference as JaxKmerReference
from shotgun_tpu.utils.synth import synth_genomes, synth_reads, to_fastq
from shotgun_tpu_torch import convert
from shotgun_tpu_torch.aligner import PseudoAlignment
from shotgun_tpu_torch.index import device_build as tdb
from shotgun_tpu_torch.index import hashtable as tht
from shotgun_tpu_torch.ops.probe import HashTableDev, probe_kmers
from shotgun_tpu_torch.ops.probe_sort import SortedTableDev
from shotgun_tpu_torch.reference import KmerReference

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _genomes_from_strings(seqs):
    return pack_genomes([SeqRecord([("description", f"g{i}"), ("genome", s)])
                         for i, s in enumerate(seqs)])


def _masks(masks, width):
    out = np.zeros((masks.shape[0], width), dtype=np.uint8)
    out[:, : masks.shape[1]] = masks
    return out


def _membership(masks, sid, width):
    """Per-key record-membership rows."""
    return _masks(masks, width)[sid]


def _check_equal(genomes, k):
    """The port's build equals the host index and the JAX device build."""
    host = build_index(genomes, k)
    dev = tdb.device_build_tables(genomes, k, CPU)
    jdev = jax_device_build(genomes, k, JaxKmerReference._pad_rows)
    assert dev is not None and jdev is not None
    jax_tab = convert.device_build(jdev, CPU)
    keys = dev["keys"].numpy()
    host_keys = (host.kmer_hi.astype(np.int64) << 32) | host.kmer_lo.astype(np.int64)
    assert dev["num_kmers"] == host.num_kmers == jdev["num_kmers"] == keys.size
    np.testing.assert_array_equal(keys, host_keys)
    np.testing.assert_array_equal(jax_tab["keys"].numpy(), host_keys)
    np.testing.assert_array_equal(dev["gc"].numpy(), host.genome_counts())
    np.testing.assert_array_equal(jax_tab["gc"].numpy(), host.genome_counts())
    width = max(dev["set_masks"].shape[1], host.set_masks.shape[1],
                jdev["set_masks"].shape[1])
    want = _membership(host.set_masks, host.set_id, width)
    np.testing.assert_array_equal(
        _membership(dev["set_masks"], dev["sid"].numpy(), width), want)
    np.testing.assert_array_equal(
        _membership(jax_tab["set_masks"], jax_tab["sid"].numpy(), width), want)
    assert dev["num_sets"] == jdev["num_sets"]
    return dev


def _r1024_shared():
    rng = np.random.default_rng(8)
    base = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(64)]
    seqs = [base[i % 64][:20] + "NN" + base[i % 64][20:] if i % 5 == 0
            else base[i % 64] for i in range(1024)]
    return _genomes_from_strings(seqs)


CORPORA = {
    "synthetic": (lambda: synth_genomes(np.random.default_rng(0), 5, 3_000), 31),
    "small_k": (lambda: synth_genomes(np.random.default_rng(1), 3, 500), 11),
    "ns_and_short_records": (lambda: _genomes_from_strings([
        "ACGTACGTACGTNNACGTACGTACGTACGT", "TTT",
        "ACGTACGTACGTACGTACGTACGTACGTACGT", "NNNNNNNNNNNNNNNN",
        "ACGTACGTACGTACGT" * 4]), 11),
    "duplicate_genomes": (lambda: _genomes_from_strings(
        ["ACGTACGTACGTACGTACGTACG"] * 3 + ["TTTTTTTTTTTTTTTTTTTTTTT"]), 21),
    "many_records": (lambda: synth_genomes(np.random.default_rng(7), 200, 300), 21),
    "r1024_shared_sets": (_r1024_shared, 15),
}


@pytest.mark.parametrize("name", list(CORPORA))
def test_device_build_matches_host_and_jax(name):
    make, k = CORPORA[name]
    dev = _check_equal(make(), k)
    if name == "r1024_shared_sets":
        assert dev["num_sets"] > 1024  # multi-record sets were numbered


@pytest.mark.parametrize("case", ["k75", "too_many_records"])
def test_device_build_rejects_unsupported(case):
    if case == "k75":
        genomes, k = synth_genomes(np.random.default_rng(2), 2, 400), 75
    else:
        genomes, k = _genomes_from_strings(["ACGTACGTACGTACGT"] * (tdb.R_CAP + 1)), 11
    assert jax_device_build(genomes, k, JaxKmerReference._pad_rows) is None
    assert tdb.device_build_tables(genomes, k, CPU) is None
    assert KmerReference.from_device_build(genomes, k, CPU) is None


def test_forced_hash_collision_returns_none(monkeypatch):
    """Two different two-record sets, {g0, g1} and {g2, g3}: with a
    constant mixer their hashes collide, and the pair-count check must
    reject the merged set."""
    rng = np.random.default_rng(4)
    a, b = ("".join(rng.choice(list("ACGT"), size=200)) for _ in range(2))
    own = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(4)]
    genomes = _genomes_from_strings([own[0] + a, a + own[1], own[2] + b, b + own[3]])
    assert _check_equal(genomes, 21)["num_sets"] == 6
    monkeypatch.setattr(tdb, "_mix32", lambda x: torch.full_like(x, 12345))
    assert tdb.device_build_tables(genomes, 21, CPU) is None


def test_host_prep_numpy_equals_native(monkeypatch):
    """Without the native library the numpy pack gives the same codes and
    the same N positions."""
    from shotgun_tpu.io import native

    genomes = _genomes_from_strings([
        "ACGTNNACGTACGTNACGTACGTACGTNNNNACGT", "NNNN",
        "ACGTACGTACGTACGTACGTACGTACGTACG", "TTTTNTTTT"])
    codes_a, runs_a = tdb._host_prep(genomes)
    monkeypatch.setattr(native, "pack2", lambda *a, **kw: None)
    codes_b, runs_b = tdb._host_prep(genomes)
    np.testing.assert_array_equal(codes_a, codes_b)

    def plane(runs):
        d = np.zeros(genomes.codes.size + 1, np.int64)
        np.add.at(d, runs[:, 0], 1)
        np.add.at(d, runs[:, 1], -1)
        return np.cumsum(d[:-1]) > 0

    np.testing.assert_array_equal(plane(runs_a), genomes.codes >= 4)
    np.testing.assert_array_equal(plane(runs_b), genomes.codes >= 4)


def test_device_hash_table_probes_like_host(monkeypatch):
    """The device-assembled 16-slot table: bit-identical to the host
    builder's on the same rows, and probing it gives the host truth's
    (hit, genome count, membership) for present and absent keys; a
    device-built reference above the (patched) auto threshold assembles
    and picks it lazily."""
    rng = np.random.default_rng(21)
    genomes = synth_genomes(rng, 6, 5_000)
    genomes.codes[5_000: 6_000] = genomes.codes[:1_000]
    k = 21
    host = build_index(genomes, k)
    built = tdb.device_build_tables(genomes, k, CPU)
    table, stash = tdb.device_hash_table(built)
    keys = built["keys"].numpy()
    ref_pt = tht.build_probe_table(
        (keys & 0xFFFFFFFF).astype(np.uint32), (keys >> 32).astype(np.uint32),
        built["sid"].numpy(), built["gc"].numpy(), slots_per_bucket=16)
    np.testing.assert_array_equal(table.numpy().view(np.uint32), ref_pt.table)
    np.testing.assert_array_equal(stash.numpy().view(np.uint32), ref_pt.stash)

    absent = keys ^ 0x5
    hit, sid, gc, _ = (x.numpy() for x in probe_kmers(
        table, stash, torch.from_numpy(np.concatenate([keys, absent])[None])))
    hit, sid, gc = hit[0], sid[0], gc[0]
    u = keys.size
    assert hit[:u].all()
    np.testing.assert_array_equal(gc[:u], host.genome_counts())
    width = max(built["set_masks"].shape[1], host.set_masks.shape[1])
    np.testing.assert_array_equal(
        _membership(built["set_masks"], sid[:u], width),
        _membership(host.set_masks, host.set_id, width))
    assert not hit[u:][~np.isin(absent, keys)].any()

    monkeypatch.setattr(KmerReference, "AUTO_HASH_MIN_KEYS", 1000)
    ref = KmerReference.from_device_build(genomes, k, CPU)
    assert not any(m == "hash16" for m, _ in ref._device_tables)  # lazy
    assert ref.probe_method() == "hash16"
    assert isinstance(ref.device_probe_tables(CPU), HashTableDev)
    assert ("hash16", "cpu") in ref._device_tables


def test_device_hash_table_over_budget_falls_back_to_sort(monkeypatch):
    """A table over the memory budget is a deterministic failure: it is
    kept, 'auto' takes the sort join, and an explicit 'hash16' raises."""
    monkeypatch.setattr(KmerReference, "AUTO_HASH_MIN_KEYS", 100)
    monkeypatch.setenv(tdb.HBM_BUDGET_ENV, "1000")
    genomes = synth_genomes(np.random.default_rng(5), 2, 800)
    ref = KmerReference.from_device_build(genomes, 11, CPU)
    assert tdb.device_hash_table(ref._built) is None
    assert isinstance(ref.device_probe_tables(CPU), SortedTableDev)
    assert ref._hash16_failed and ref.probe_method() == "sort"
    with pytest.raises(RuntimeError, match="memory budget"):
        ref.device_probe_tables(CPU, "hash16")


@pytest.mark.parametrize("budget", ["600000", "10GB"])
def test_hbm_budget_check_follows_jax(budget, monkeypatch):
    """The budget pre-check counts the build's windows, as the JAX check
    counts its table's rows: on a repetitive panel (far fewer distinct
    keys than windows) a budget that the table and a per-key workspace
    would fit, but the per-window workspace does not, refuses the table
    in both packages.  A budget that is not an integer raises in both."""
    from shotgun_tpu.index.device_build import device_hash_table as jax_hash_table

    seq = "".join(np.random.default_rng(6).choice(list("ACGT"), size=2_000))
    genomes = _genomes_from_strings([seq] * 20)
    k = 21
    built = tdb.device_build_tables(genomes, k, CPU)
    jbuilt = jax_device_build(genomes, k, JaxKmerReference._pad_rows)
    assert built["num_windows"] == genomes.codes.size - k + 1
    monkeypatch.setenv(tdb.HBM_BUDGET_ENV, budget)
    if budget == "10GB":
        for fn, b in ((tdb.device_hash_table, built), (jax_hash_table, jbuilt)):
            with pytest.raises(ValueError):
                fn(b)
        return
    u = built["num_kmers"]
    nb = 1 << max(int(max(u / tdb.HASH_LAMBDA, 1)) - 1, 1).bit_length()
    table_bytes = nb * tdb.HASH_SLOTS * 16
    assert table_bytes + 32 * u < int(budget) < table_bytes + 32 * built["num_windows"]
    assert tdb.device_hash_table(built) is None
    assert jax_hash_table(jbuilt) is None
    assert tdb.device_hash_table(convert.device_build(jbuilt, CPU)) is None
    monkeypatch.delenv(tdb.HBM_BUDGET_ENV)
    assert tdb.device_hash_table(built) is not None


def _workload(seed):
    rng = np.random.default_rng(seed)
    genomes = synth_genomes(rng, 4, 2_000)
    genomes.codes[2_000: 2_500] = genomes.codes[:500]
    genomes.codes[3_000: 3_004] = 4
    reads = synth_reads(rng, genomes, 256, 80)
    mutate = rng.random(reads.codes.shape) < 0.03
    reads.codes[mutate] = rng.integers(0, 4, size=mutate.sum())
    reads.qual[:] = rng.integers(60, 91, size=reads.qual.shape)
    return genomes, reads


@pytest.mark.parametrize("route", ["stream", "container"])
@pytest.mark.parametrize("probe", ["sort", "hash16"])
def test_device_built_aligns_like_host_built(route, probe, tmp_path, monkeypatch):
    """Summaries from device-built and host-built references equal the JAX
    package's, through the stream and the container routes, on the sort
    join and (above a patched crossover) the device-assembled table."""
    if probe == "hash16":
        monkeypatch.setattr(KmerReference, "AUTO_HASH_MIN_KEYS", 500)
    k = 21
    genomes, reads = _workload(22)
    fq = tmp_path / "reads.fq"
    fq.write_text(to_fastq(reads))
    gates = (70, 74, 2)
    jpa = JaxPseudoAlignment(JaxKmerReference(k, _index=build_index(genomes, k)))
    jpa.align_stream(open_fastq_stream(str(fq), lazy=True), 1, 1, *gates,
                     batch_size=64)
    want = jpa.get_summary()
    assert want["Statistics"]["ambiguous_mapped_reads"] > 0

    for ref in (KmerReference.from_device_build(genomes, k, CPU),
                KmerReference(k, genomes)):
        pa = PseudoAlignment(ref, CPU)
        if route == "stream":
            pa.align_stream(open_fastq_stream(str(fq), lazy=True), 1, 1, *gates,
                            batch_size=64)
        else:
            pa.align_reads_from_container(FASTAQFile(str(fq)).container, 1, 1,
                                          *gates, batch_size=64)
        assert ref.probe_method() == probe
        assert pa.get_summary() == want
