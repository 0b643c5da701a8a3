"""The port's sort-join probe (shotgun_tpu_torch.ops.probe_sort2: one
join over 31-base key words, one word at k <= 31) and the pipeline's sort
routes against the JAX package's probes of k <= 31 and of multi-word
keys, on identical inputs.  All four probe
outputs and every BatchResult field are compared exactly."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shotgun_tpu.index.build import build_index
from shotgun_tpu.index.device_build import device_build_tables as jax_device_build
from shotgun_tpu.io.packing import pack_genomes
from shotgun_tpu.io.records import SeqRecord
from shotgun_tpu.models import pipeline as jpipe
from shotgun_tpu.ops.encode import pack_codes_2bit, rolling_encode_jnp
from shotgun_tpu.ops.probe_sort import SortedTableDev as JaxSortedTableDev
from shotgun_tpu.ops.probe_sort import sorted_table_host as jax_sorted_table_host
from shotgun_tpu.ops.encode import rolling_encode_words_jnp as jenc_words
from shotgun_tpu.ops.probe_sort2 import probe_dedupe_sorted as jax_probe
from shotgun_tpu.ops.probe_sort2 import probe_dedupe_sorted_words as jax_probe_words
from shotgun_tpu.reference import KmerReference as JaxKmerReference
from shotgun_tpu.utils.synth import synth_genomes, synth_reads
from shotgun_tpu_torch import convert
from shotgun_tpu_torch.models import pipeline as tpipe
from shotgun_tpu_torch.ops.encode import encode_words_plain
from shotgun_tpu_torch.ops.probe_sort import SortedTableDev, sorted_table, sorted_table_host
from shotgun_tpu_torch.ops.probe_sort2 import probe_dedupe_sorted, probe_dedupe_sorted_words

torch.set_num_threads(2)
CPU = torch.device("cpu")
GATES = [(False, False, False), (True, False, False), (False, True, False),
         (False, False, True), (True, True, False), (True, False, True),
         (False, True, True), (True, True, True)]
OUTPUTS = ("hit", "set_id", "genome_count", "first_occ")


def _keys(lo, hi):
    return (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).astype(np.int64)


def _both_probes(jtab, codes, ok, num_sets, max_genome_count):
    """(port outputs, JAX outputs) as numpy, for uint8 codes [B, L]."""
    lo, hi = rolling_encode_jnp(jnp.asarray(codes), codes.shape[1] - ok.shape[1] + 1)
    want = jax.jit(lambda lo, hi, ok: jax_probe(
        jtab, lo, hi, ok, num_sets=num_sets,
        max_genome_count=max_genome_count))(lo, hi, jnp.asarray(ok))
    got = probe_dedupe_sorted(convert.sorted_table(jtab, CPU),
                              torch.from_numpy(_keys(lo, hi)), torch.from_numpy(ok))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _assert_equal(got, want):
    for g, w, name in zip(got, want, OUTPUTS):
        np.testing.assert_array_equal(g, w, err_msg=name)


def _reads_with_duplicates(rng, genomes, b, l, k):
    """Reads whose every third row tiles its first k-mer over half the
    read, so k-mers repeat within a read."""
    codes = np.array(synth_reads(rng, genomes, b, l).codes)
    codes[::3, : l // 2] = np.tile(
        codes[::3, :k], (1, (l // 2 + k - 1) // k))[:, : l // 2]
    return codes


def _gates(rng, codes, k):
    """Validity by random read lengths, and ~10% of windows gated as MKQ."""
    b, l = codes.shape
    w = l - k + 1
    lens = rng.integers(k - 1, l + 1, size=b)
    return (np.arange(w)[None, :] < (lens - (k - 1))[:, None]) & (rng.random((b, w)) > 0.1)


def _jax_table(kind, genomes, k):
    """A JAX SortedTableDev with dead rows: the reference's shape-bucket
    pads ('host'), or the device build's one row per window with invalid
    windows as dead rows ('device')."""
    if kind == "host":
        jref = JaxKmerReference(k, _index=build_index(genomes, k))
        return jref.device_probe_tables("sort"), jref.index.num_sets
    built = jax_device_build(genomes, k, JaxKmerReference._pad_rows)
    tab = JaxSortedTableDev(klo=built["klo"], khi=built["khi"],
                            sid=built["sid"], gc=built["gc"])
    return tab, built["num_sets"]


@pytest.mark.parametrize("kind", ["host", "device"])
@pytest.mark.parametrize(
    "ng,glen,b,l,k", [(3, 2000, 64, 50, 11), (5, 5000, 128, 80, 31), (2, 300, 32, 40, 7)])
def test_probe_dedupe_sorted_matches_jax(kind, ng, glen, b, l, k):
    rng = np.random.default_rng(ng * 1000 + k)
    genomes = synth_genomes(rng, ng, glen)
    genomes.codes[glen: glen + glen // 4] = genomes.codes[: glen // 4]  # shared
    genomes.codes[glen // 2: glen // 2 + 3] = 4  # an N run: dead device rows
    codes = _reads_with_duplicates(rng, genomes, b, l, k)
    ok = _gates(rng, codes, k)
    jtab, num_sets = _jax_table(kind, genomes, k)
    live = np.asarray(jtab.gc) > 0
    assert not live.all()
    if kind == "device":  # the JAX device table repeats keys
        keys = _keys(jtab.klo, jtab.khi)[live]
        assert (keys[1:] == keys[:-1]).any()
    got, want = _both_probes(jtab, codes, ok, num_sets, ng)
    _assert_equal(got, want)
    hit, fo = want[0], want[3]
    assert hit.any() and (ok & ~hit).any()
    assert (hit & ~fo).any() or 2 * k > l // 2  # repeats need two k-mers' room


def test_empty_table():
    rng = np.random.default_rng(1)
    empty = np.zeros(0, dtype=np.uint32)
    jtab = JaxSortedTableDev(*(jnp.asarray(empty.astype(t))
                               for t in (np.uint32, np.uint32, np.int32, np.int32)))
    codes = rng.integers(0, 4, size=(8, 30), dtype=np.uint8)
    got, want = _both_probes(jtab, codes, np.ones((8, 20), dtype=bool), 1, 1)
    _assert_equal(got, want)
    assert (got[1] == -1).all() and not got[0].any()


def test_table_of_dead_rows_only_is_empty():
    tab = sorted_table((np.arange(5, dtype=np.int64),), np.zeros(5, np.int32),
                       np.zeros(5, np.int32), CPU)
    assert tab.words[0].numel() == 0
    hit, sid, gc, fo = probe_dedupe_sorted(
        tab, torch.arange(6).reshape(2, 3), torch.ones((2, 3), dtype=torch.bool))
    assert not hit.any() and (sid == -1).all() and (gc == 0).all() and not fo.any()


def test_wide_payload_is_exact():
    """Set ids and genome counts wider than the JAX carry words (its
    sid_bits + gc_bits > 32 case) come back exactly."""
    k = 11
    rng = np.random.default_rng(7)
    genomes = synth_genomes(rng, 3, 800)
    klo, khi, sid, gc = jax_sorted_table_host(build_index(genomes, k))
    jtab = JaxSortedTableDev(klo=jnp.asarray(klo), khi=jnp.asarray(khi),
                             sid=jnp.asarray(sid * 997), gc=jnp.full(gc.shape, 5000, jnp.int32))
    codes = np.array(synth_reads(rng, genomes, 8, 40).codes)
    got, want = _both_probes(jtab, codes, np.ones((8, 30), dtype=bool), 2 ** 20, 8192)
    _assert_equal(got, want)
    assert got[0].any() and (got[2][got[0]] == 5000).all()


def test_poly_t_kmer_gated_and_ok():
    """k = 31: the all-T k-mer is 2**62 - 1, whose tagged key is int64
    max.  A gated window and an ok window both carry it; only the ok one
    hits, and the table holds it."""
    k = 31
    seqs = ["ACGTTGCA" * 8 + "T" * 40 + "GATTACA" * 6, "CCGGA" * 20]
    genomes = pack_genomes([SeqRecord([("description", f"g{i}"), ("genome", s)])
                            for i, s in enumerate(seqs)])
    index = build_index(genomes, k)
    (keys,), _, _ = sorted_table_host(convert.kmer_index(index))
    assert keys[-1] == (1 << 62) - 1
    jtab = JaxKmerReference(k, _index=index).device_probe_tables("sort")
    codes = np.full((4, 50), 3, dtype=np.uint8)  # every window all-T
    codes[1, 10:] = genomes.codes[:40]
    ok = np.ones((4, 20), dtype=bool)
    ok[0, :5] = False          # gated all-T windows before ok ones
    ok[2, 1::2] = False        # alternating gated / ok
    ok[3] = False              # a read with every window gated
    got, want = _both_probes(jtab, codes, ok, index.num_sets, 2)
    _assert_equal(got, want)
    assert not got[0][0, :5].any() and got[3][0, 5] and got[0][0, 6:].all()
    assert not got[0][3].any() and got[3][2, 0] and not got[3][2, 2]


@functools.lru_cache(maxsize=None)
def _jax_core(k, has_mrq, has_mkq, has_mg):
    return jax.jit(functools.partial(
        jpipe.align_batch_core, k=k, has_mrq=has_mrq, has_mkq=has_mkq,
        has_mg=has_mg, packed=True))


@pytest.mark.parametrize("gates", GATES)
def test_align_batch_sort_route_matches_jax(gates):
    """The pipeline on the sort route against JAX ``align_batch_core``
    with a SortedTableDev, field by field."""
    k, l, b = 21, 64, 96
    rng = np.random.default_rng(sum(g << i for i, g in enumerate(gates)))
    genomes = synth_genomes(rng, 4, 2000)
    genomes.codes[2000: 2400] = genomes.codes[:400]  # shared k-mers
    reads = synth_reads(rng, genomes, b, 60)
    codes = np.zeros((b, l), dtype=np.uint8)
    codes[:, :60] = reads.codes
    mutate = rng.random(codes.shape) < 0.03
    codes[mutate] = rng.integers(0, 4, size=mutate.sum())
    codes[::4, 5:30] = codes[::4, 30:55]  # within-read repeats
    qual = np.zeros((b, l), dtype=np.uint8)
    qual[:, :60] = rng.integers(60, 91, size=(b, 60))
    lengths = rng.integers(k - 2, 61, size=b).astype(np.int32)
    qual[np.arange(l)[None, :] >= lengths[:, None]] = 0
    jref = JaxKmerReference(k, _index=build_index(genomes, k))
    jtab = jref.device_probe_tables("sort")
    member = jref.set_member_dense()
    params = (1, 1, 72, 74, 2)
    packed = pack_codes_2bit(codes)
    want = _jax_core(k, *gates)(
        jtab, jnp.asarray(member), jnp.asarray(packed), jnp.asarray(qual),
        jnp.asarray(lengths), *(jnp.int32(v) for v in params))
    tab = convert.sorted_table(jtab, CPU)
    assert isinstance(tab, SortedTableDev)
    got = tpipe.align_batch(
        tab, torch.from_numpy(member), torch.from_numpy(packed),
        torch.from_numpy(qual) if gates[0] or gates[1] else None,
        torch.from_numpy(lengths), *params, k=k, has_mrq=gates[0],
        has_mkq=gates[1], has_mg=gates[2])
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    mtype = np.asarray(want.mtype)
    assert (mtype == 1).any() and (mtype == 2).any()


# --- multi-word keys (k > 31): the port's join of 31-base words against
# the JAX package's probe_dedupe_sorted_words on 16-base words

WORD_KS = [32, 35, 62, 63, 64, 75, 93, 150]


def _word_genomes(rng, k):
    """Three genomes with shared k-mers and a poly-T run longer than k, so
    the table holds the all-T key (at k = 64 JAX's all-ones pad key)."""
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=600)) for _ in range(3)]
    seqs[1] = seqs[0][:200] + seqs[1][200:]
    seqs[2] = seqs[2][:100] + "T" * (k + 20) + seqs[2][100:]
    return pack_genomes([SeqRecord([("description", f"g{i}"), ("genome", s)])
                         for i, s in enumerate(seqs)])


@pytest.mark.parametrize("k", WORD_KS)
def test_probe_dedupe_sorted_words_matches_jax(k):
    """On the word table of a host index (JAX's with its pad rows, the
    port's converted without them): reads with keys repeated within the
    read, an all-T read, gated windows among ok ones, a read whose every
    window is gated."""
    rng = np.random.default_rng(4000 + k)
    genomes = _word_genomes(rng, k)
    index = build_index(genomes, k)
    jtab = JaxKmerReference(k, _index=index).device_probe_tables("sort")
    assert (np.asarray(jtab.gc) == 0).any()  # JAX's pad rows
    b, l = 24, 4 * ((k + 50) // 4)
    codes = _reads_with_duplicates(rng, genomes, b, l, k)
    codes[1] = 3                               # every window all-T
    codes[2, : l // 2] = codes[2, l // 2: 2 * (l // 2)]  # the read's halves repeat
    ok = _gates(rng, codes, k)
    ok[1, ::3] = False
    ok[3] = False
    want = jax.jit(lambda qws, ok: jax_probe_words(
        jtab, qws, ok, num_sets=index.num_sets, max_genome_count=3))(
        jenc_words(jnp.asarray(codes), k), jnp.asarray(ok))
    tab = convert.sorted_table_words(jtab, k, CPU)
    assert isinstance(tab, SortedTableDev) and tab.sid.numel() == index.num_kmers
    words, _ = encode_words_plain(torch.from_numpy(pack_codes_2bit(codes)), k)
    got = probe_dedupe_sorted_words(tab, words, torch.from_numpy(ok))
    _assert_equal([g.numpy() for g in got], [np.asarray(w) for w in want])
    hit, fo = got[0].numpy(), got[3].numpy()
    assert hit[1].any() and not hit[1, ::3].any() and not hit[3].any()
    assert (hit & ~fo).any() and (ok & ~hit).any()
    # the host table of the port's own index is the converted JAX table
    host = sorted_table(*sorted_table_host(convert.kmer_index(index)), CPU)
    for a, c in zip(host.words + (host.sid, host.gc), tab.words + (tab.sid, tab.gc)):
        assert torch.equal(a, c)


def test_probe_dedupe_sorted_words_on_an_empty_table():
    empty = sorted_table([np.zeros(0, np.int64)] * 3, np.zeros(0, np.int32),
                         np.zeros(0, np.int32), CPU)
    words = tuple(torch.zeros((2, 4), dtype=torch.int64) for _ in range(3))
    hit, sid, gc, fo = probe_dedupe_sorted_words(empty, words, torch.ones((2, 4), dtype=torch.bool))
    assert not hit.any() and (sid == -1).all() and (gc == 0).all() and not fo.any()


@pytest.mark.parametrize("k,gates", [(35, (False, False, False)), (64, (True, True, True)),
                                     (75, (False, True, False)), (150, (True, True, True))])
def test_align_batch_word_route_matches_jax(k, gates):
    """The pipeline on the multi-word route against JAX ``align_batch_core``
    with a SortedTableDevW (the port's SortedTableDev of the same words),
    field by field."""
    rng = np.random.default_rng(k)
    l, b = 4 * ((k + 60) // 4), 48
    genomes = synth_genomes(rng, 4, 1500)
    genomes.codes[1500: 1900] = genomes.codes[:400]  # shared k-mers
    reads = synth_reads(rng, genomes, b, l)
    codes = np.array(reads.codes)
    mutate = rng.random(codes.shape) < 0.01
    codes[mutate] = rng.integers(0, 4, size=mutate.sum())
    qual = rng.integers(60, 91, size=(b, l)).astype(np.uint8)
    lengths = rng.integers(k - 2, l + 1, size=b).astype(np.int32)
    qual[np.arange(l)[None, :] >= lengths[:, None]] = 0
    jref = JaxKmerReference(k, _index=build_index(genomes, k))
    jtab = jref.device_probe_tables("sort")
    member = jref.set_member_dense()
    params = (1, 1, 72, 74, 2)
    packed = pack_codes_2bit(codes)
    want = _jax_core(k, *gates)(
        jtab, jnp.asarray(member), jnp.asarray(packed), jnp.asarray(qual),
        jnp.asarray(lengths), *(jnp.int32(v) for v in params))
    got = tpipe.align_batch(
        convert.sorted_table_words(jtab, k, CPU), torch.from_numpy(member),
        torch.from_numpy(packed), torch.from_numpy(qual) if gates[0] or gates[1] else None,
        torch.from_numpy(lengths), *params, k=k, has_mrq=gates[0], has_mkq=gates[1],
        has_mg=gates[2])
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (np.asarray(want.mtype) == 1).any()
