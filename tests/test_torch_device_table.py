"""The 4- and 16-slot hash tables of a host index assembled on the device
(``shotgun_tpu_torch.index.device_build.index_hash_table``) against the
host builders of both packages (``index.hashtable.build_probe_table``):
bit for bit, stash included, on host-built, loaded and EXTSIM-filtered
indexes, with genome-count-0 rows and with a stash that overflows at the
first bucket count.  Then the route: the budget's refusal takes the host
builder, and with the host builder made to raise the ``-r`` CLI runs print
the JAX CLI's bytes on auto, hash and hash16.  Also the int64 view of
``ops.probe_sort.host_key_words``.  Tolerance 0 throughout."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from shotgun_tpu import cli as jax_cli
from shotgun_tpu.index import hashtable as jht
from shotgun_tpu.index.build import build_index
from shotgun_tpu.index.extsim import apply_similarity_filter
from shotgun_tpu.io.packing import GenomeArrays as JaxGenomeArrays
from shotgun_tpu.ops import encode as jenc
from shotgun_tpu.reference import KmerReference as JaxKmerReference
from shotgun_tpu.utils.synth import synth_genomes
from shotgun_tpu_torch import cli, convert
from shotgun_tpu_torch import reference as treference
from shotgun_tpu_torch.index import device_build as tdb
from shotgun_tpu_torch.index import hashtable as tht
from shotgun_tpu_torch.index.build import KmerIndex
from shotgun_tpu_torch.ops.probe import HashTableDev
from shotgun_tpu_torch.ops.probe_sort import host_key_words, key_words_from_u32
from shotgun_tpu_torch.reference import KmerReference
from shotgun_tpu_torch.utils.profiling import PROFILER
from shotgun_tpu_torch.utils.synth import make_genomes

torch.set_num_threads(2)
CPU = torch.device("cpu")
EMPTY = np.uint32(0xFFFFFFFF)
HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "golden", "data")
FA, FQ = os.path.join(DATA, "corpus.fa"), os.path.join(DATA, "corpus.fq")
SLOTS = [4, 16]


def _check(index, slots):
    """The device assembly of the port's ``index`` equals the port's host
    table bit for bit, and the JAX package's on every word it writes (the
    JAX builder leaves the key words of empty slots uninitialised); the
    assembled table, for the caller's checks."""
    ht = tdb.index_hash_table(index, slots, CPU)
    assert ht is not None
    table, stash = (x.numpy().view(np.uint32) for x in ht)
    cols = (index.kmer_lo, index.kmer_hi, index.set_id, index.genome_counts())
    want = tht.build_probe_table(*cols, slots_per_bucket=slots)
    np.testing.assert_array_equal(table, want.table)
    np.testing.assert_array_equal(stash, want.stash)
    jax = jht.build_probe_table(*cols, slots_per_bucket=slots)
    assert table.shape == (jax.n_buckets, slots, 4)
    np.testing.assert_array_equal(stash, jax.stash)
    np.testing.assert_array_equal(table[..., 2], jax.table[..., 2])
    occupied = jax.table[..., 2] != EMPTY
    np.testing.assert_array_equal(table[occupied], jax.table[occupied])
    assert int(occupied.sum()) + stash.shape[0] == index.num_kmers
    return table, stash


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("k", [1, 11, 31])
def test_host_built_index(k, slots):
    genomes = synth_genomes(np.random.default_rng(k), 6, 6_000)
    genomes.codes[6_000: 7_000] = genomes.codes[:1_000]  # shared k-mers
    _check(convert.kmer_index(build_index(genomes, k)), slots)


@pytest.mark.parametrize("slots", SLOTS)
def test_index_loaded_from_a_jax_kdb(slots, tmp_path):
    genomes = synth_genomes(np.random.default_rng(7), 4, 8_000)
    kdb = str(tmp_path / "x.kdb")
    JaxKmerReference(31, _index=build_index(genomes, 31)).save(kdb)
    ref = KmerReference.load(kdb, device=CPU)
    _check(ref.index, slots)


@pytest.mark.parametrize("slots", SLOTS)
def test_extsim_filtered_index(slots):
    """Both packages' EXTSIM filter on a panel of near copies: the same
    kept records, and each filtered index's table assembled bit-equal."""
    g = make_genomes(np.random.default_rng(3), 8, 4_000, strains=3, mutation_rate=0.01)
    port = KmerReference(21, g, filter_similar=True, similarity_threshold=0.5,
                         device=CPU).index
    jax = apply_similarity_filter(
        build_index(JaxGenomeArrays(list(g.descriptions), g.codes, g.offsets), 21), 0.5)
    assert 0 < port.kept.sum() < port.num_records
    np.testing.assert_array_equal(port.kept, jax.kept)
    for index in (port, convert.kmer_index(jax)):
        _check(index, slots)


def _planted_index(slots, n_base=3_000, n_planted=120, zero_set=3):
    """A k = 31 index whose first bucket count overflows the stash: more
    than STASH_CAP + slots of its keys share one bucket there; the rows
    of set ``zero_set`` have genome count 0."""
    rng = np.random.default_rng(slots)
    keys = np.unique(rng.integers(0, 1 << 62, size=n_base, dtype=np.int64))
    nb = jht._next_pow2(max(int((keys.size + n_planted) / jht._TARGET_LAMBDA[slots]), 1))
    cand = np.unique(rng.integers(0, 1 << 62, size=1 << 21, dtype=np.int64))
    lo, hi = (cand & 0xFFFFFFFF).astype(np.uint32), (cand >> 32).astype(np.uint32)
    bucket = jenc.mix32(lo, hi, np) & np.uint32(nb - 1)
    same = cand[bucket == np.bincount(bucket).argmax()][:n_planted]
    assert same.size == n_planted
    keys = np.unique(np.concatenate([keys, same]))
    u = keys.size
    words = np.stack([(keys & 0xFFFFFFFF).astype(np.uint32),
                      (keys >> 32).astype(np.uint32)], axis=1)
    set_sizes = rng.integers(1, 5, size=40).astype(np.int32)
    set_sizes[zero_set] = 0
    return KmerIndex(
        k=31, descriptions=["g"], record_lengths=np.zeros(1, np.int64),
        kept=np.ones(1, bool), kmer_words=words, first_seen=np.arange(u, dtype=np.int64),
        post_offsets=np.zeros(u + 1, np.int64), post_record=np.zeros(0, np.int32),
        post_pos=np.zeros(0, np.int64),
        set_id=rng.integers(0, 40, size=u).astype(np.int32),
        set_masks=np.zeros((40, 1), np.uint8), set_sizes=set_sizes), nb


@pytest.mark.parametrize("slots", SLOTS)
def test_stash_overflow_doubles_as_the_host_builder(slots):
    """Doubled from the first bucket count until the stash fits, as the
    host builders double; genome-count-0 rows placed like any other."""
    index, first = _planted_index(slots)
    assert (index.genome_counts() == 0).any()
    table, stash = _check(index, slots)
    assert table.shape[0] > first and 0 < stash.shape[0] <= tht.STASH_CAP
    assert (table[..., 3][table[..., 2] != EMPTY] == 0).any()


@pytest.mark.parametrize("slots", SLOTS)
def test_budget_refusal_takes_the_host_builder(slots, monkeypatch):
    """A budget one byte below the term of the host builder's bucket count
    refuses the table (at the first count, or for the planted index at its
    last doubling): the route builds on the host, names stage
    hash_table_host, and gives the same table; the term itself is
    admitted and names hash_table_device."""
    method = "hash16" if slots == 16 else "hash"
    genomes = synth_genomes(np.random.default_rng(5), 3, 4_000)
    for index in (convert.kmer_index(build_index(genomes, 11)), _planted_index(slots)[0]):
        nb = jht.build_probe_table(index.kmer_lo, index.kmer_hi, index.set_id,
                                   index.genome_counts(), slots_per_bucket=slots).n_buckets
        term = tdb.index_table_bytes(index.num_kmers, index.num_sets, slots, nb)
        tables = {}
        for budget in (term - 1, term):
            monkeypatch.setenv(tdb.HBM_BUDGET_ENV, str(budget))
            assert (tdb.index_hash_table(index, slots, CPU) is None) == (budget < term)
            PROFILER.stats.clear()
            PROFILER.enable()
            try:
                tab = KmerReference(index.k, _index=index, device=CPU).device_probe_tables(
                    CPU, method)
            finally:
                PROFILER.enabled = False
            stages = set(PROFILER.stats)
            PROFILER.stats.clear()
            assert isinstance(tab, HashTableDev)
            route = "hash_table_host" if budget < term else "hash_table_device"
            assert route in stages and stages <= {"hash_table_host", "hash_table_device"}
            tables[budget] = tab
        for a, b in zip(*tables.values()):
            assert torch.equal(a, b)


def test_index_term_counts_the_table_and_five_bytes_a_key():
    """The loaded-index term at 100M keys: the 2^25-bucket 16-slot table,
    5 B a key and one chunk's workspace, under the 10 GB default."""
    u, nb = 100_000_000, 1 << 25
    term = tdb.index_table_bytes(u, 1000, 16, nb)
    assert term == nb * 16 * 16 + 5 * u + 4 * 1000 + tdb._CHUNK * tdb._CHUNK_ROW_BYTES
    assert term < tdb.HBM_BUDGET_DEFAULT


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("task", ["dumpalign", "align"])
@pytest.mark.parametrize("probe", ["auto", "hash", "hash16"])
def test_r_routes_print_the_jax_cli_bytes_without_the_host_builder(
        probe, task, tmp_path, monkeypatch):
    """With the port's host builder made to raise and the auto crossover
    lowered in both packages, dumpalign -r and align -r (then dumpalign
    -a) of a .kdb on auto, hash and hash16 print the JAX CLI's bytes, and
    the .aln files are equal: the table came from the device assembly
    (stage hash_table_device)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the host table builder ran")

    monkeypatch.setattr(treference, "build_probe_table", refuse)
    for cls in (KmerReference, JaxKmerReference):
        monkeypatch.setattr(cls, "AUTO_HASH_MIN_KEYS", 100)
    monkeypatch.setenv("SHOTGUN_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SHOTGUN_TPU_SUPERBATCH", "1")
    if probe == "auto":
        monkeypatch.delenv("SHOTGUN_TPU_PROBE", raising=False)
    else:
        monkeypatch.setenv("SHOTGUN_TPU_PROBE", probe)
    kdb = str(tmp_path / "x.kdb")
    _run(jax_cli.main, ["-t", "reference", "-g", FA, "-k", "11", "-r", kdb])
    outs, alns = [], []
    for tag, main in (("port", cli.main), ("jax", jax_cli.main)):
        PROFILER.stats.clear()
        argv = ["-t", task, "-r", kdb, "--reads", FQ, "--batch-size", "16"]
        if task == "align":
            alns.append(str(tmp_path / f"{tag}.aln"))
            _run(main, argv + ["-a", alns[-1]] + (["--profile"] if tag == "port" else []))
            if tag == "port":
                stages = set(PROFILER.stats)
            outs.append(_run(main, ["-t", "dumpalign", "-a", alns[-1]]))
        else:
            outs.append(_run(main, argv + (["--profile"] if tag == "port" else [])))
            if tag == "port":
                stages = set(PROFILER.stats)
    PROFILER.enabled = False
    PROFILER.stats.clear()
    assert outs[0] == outs[1] and '"unique_mapped_reads"' in outs[0]
    assert "hash_table_device" in stages and "hash_table_host" not in stages
    for a, b in zip(alns, alns[1:]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("k", [1, 11, 16, 17, 31])
def test_host_key_words_is_a_view_of_the_index_words(k):
    """At k <= 31 the index's C-contiguous [U, 2] words viewed as int64
    equal the widened words, with no copy; another layout is widened."""
    genomes = synth_genomes(np.random.default_rng(k), 3, 3_000)
    words = convert.kmer_index(build_index(genomes, k)).kmer_words
    (view,) = host_key_words(words, k)
    want = key_words_from_u32(words, k)
    assert len(want) == 1 and np.shares_memory(view, words)
    np.testing.assert_array_equal(view, want[0])
    wide = np.zeros((words.shape[0], 3), np.uint32)
    wide[:, :2] = words
    (strided,) = host_key_words(wide[:, :2], k)
    assert not np.shares_memory(strided, wide)
    np.testing.assert_array_equal(strided, want[0])


def test_host_key_words_beyond_31_widen():
    genomes = synth_genomes(np.random.default_rng(35), 2, 3_000)
    words = convert.kmer_index(build_index(genomes, 35)).kmer_words
    got, want = host_key_words(words, 35), key_words_from_u32(words, 35)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
