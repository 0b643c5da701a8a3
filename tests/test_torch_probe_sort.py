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
from shotgun_tpu_torch.ops import probe_sort2
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


# --- kernel H4 (ops/kernels/csrc/sort_probe.cu) where the card is absent:
# the wrapper's CPU route, and a numpy model of the kernel's algorithm
# (its branch-free search and its blocks' dedupe) held to the plain join

H4_KINDS = ["distinct", "repeated", "repeated, payloads differ", "empty"]
ALL_T = (1 << 62) - 1


def sort_probe_model(tab_words, sid, gc, q_words, ok, chunk=probe_sort2.H4_CHUNK):
    """(hit, set_id, genome_count, first_occ, row) of kernel H4 as its
    blocks compute them: each ok window's row is the count of table rows
    whose key is at most its own, less one, by the kernel's branch-free
    halving (a miss -1); a block owns ``chunk // W`` whole reads or one
    read walked in chunks of ``chunk`` windows; a hit is a first
    occurrence when no earlier window of its read in the chunk found its
    row and, for a read past a chunk, no earlier gated-in window of the
    earlier chunks has its key."""
    nw, u = len(tab_words), sid.size
    b, w = ok.shape
    qf = [q.reshape(-1) for q in q_words]
    okf = ok.reshape(-1)

    def le(rows, f):  # table row <= window key, lexicographically
        res, decided = np.ones(f.size, bool), np.zeros(f.size, bool)
        for tw, q in zip(tab_words, qf):
            a, x = tw[rows], q[f]
            res = np.where(~decided & (a != x), a < x, res)
            decided |= a != x
        return res

    def find(f):
        base, n = np.zeros(f.size, np.int64), u
        while n > 1:
            half = n >> 1
            base = np.where(le(base + half, f), base + half, base)
            n -= half
        row = base + le(base, f) - 1
        rowc = np.maximum(row, 0)
        hit = row >= 0
        for tw, q in zip(tab_words, qf):
            hit &= tw[rowc] == q[f]
        return np.where(hit, row, -1)

    row_out = np.full(b * w, -1, np.int64)
    first = np.zeros(b * w, bool)
    per_block = chunk // w if w <= chunk else 1
    for read0 in range(0, b, per_block):
        f0, span = read0 * w, min(per_block, b - read0) * w
        for c0 in range(0, span, chunk):
            f = f0 + c0 + np.arange(min(chunk, span - c0))
            s_row = np.full(f.size, -1, np.int64)
            live = okf[f] & (u > 0)
            s_row[live] = find(f[live])
            for i, row in enumerate(s_row):
                if row < 0:
                    continue
                start = c0 + i - (c0 + i) % w
                fo = not (s_row[max(start - c0, 0): i] == row).any()
                if fo and start < c0:
                    g = f0 + np.arange(start, c0)
                    same = okf[g].copy()
                    for q in qf:
                        same &= q[g] == q[f[i]]
                    fo = not same.any()
                first[f[i]] = fo
            row_out[f] = s_row
    hit = row_out >= 0
    rowc = np.maximum(row_out, 0)
    return tuple(x.reshape(b, w) for x in (
        hit, np.where(hit, sid[rowc] if u else 0, -1).astype(np.int32),
        np.where(hit, gc[rowc] if u else 0, 0).astype(np.int32), first, row_out))


def _run_rows(tab_words, q_words):
    """Each window's last row of its key's run, or -1 where the table lacks
    the key: ``np.searchsorted`` on word 0, narrowed on each later word."""
    out = np.full(q_words[0].size, -1, np.int64)
    for i, key in enumerate(zip(*(q.reshape(-1) for q in q_words))):
        lo, hi = 0, tab_words[0].size
        for tw, x in zip(tab_words, key):
            part = tw[lo:hi]
            lo, hi = lo + np.searchsorted(part, x, "left"), lo + np.searchsorted(part, x, "right")
        if hi > lo:
            out[i] = hi - 1
    return out.reshape(q_words[0].shape)


def _h4_case(rng, nw, kind, b=24, w=40):
    """A key-sorted table of ``nw``-word keys (word 0 from few values, so
    later words decide; the all-T 31-mer word among them) and [b, w]
    windows: table keys, keys one word off, keys below the first row and
    above the last, windows repeating an earlier one of their read, a
    read of one key, gated windows (the all-T word among them) and a read
    whose every window is gated."""
    n = 400
    cols = [rng.integers(1, 30, size=n)] + [rng.integers(0, 5, size=n) for _ in range(nw - 1)]
    cols[0][:8] = ALL_T if kind == "distinct" else 30
    keys = np.unique(np.stack(cols, 1), axis=0)          # lexicographic order
    u = keys.shape[0]
    sid = rng.integers(0, 1 << 20, size=u).astype(np.int32)
    gc = rng.integers(1, 9, size=u).astype(np.int32)
    if kind.startswith("repeated"):
        idx = np.sort(np.concatenate([np.arange(u), rng.choice(u, size=u // 3)]))
        keys, sid, gc = keys[idx], sid[idx], gc[idx]
        if kind.endswith("differ"):  # the plain join reads a run's last row
            sid, gc = sid + np.arange(sid.size, dtype=np.int32), gc + (np.arange(gc.size) % 3)
    elif kind == "empty":
        keys, sid, gc = keys[:0], sid[:0], gc[:0]
    pick = keys[rng.integers(0, max(keys.shape[0], 1), size=b * w) % max(keys.shape[0], 1)] \
        if keys.shape[0] else np.ones((b * w, nw), np.int64)
    q = pick.copy()
    draw = rng.random(b * w)
    off = (draw > 0.5) & (draw < 0.7)                     # one word off by one
    j = rng.integers(0, nw, size=b * w)
    q[off, j[off]] += np.where(q[off, j[off]] > 0, -1, 1)
    q[(draw >= 0.7) & (draw < 0.8), 0] = 0                # below the first row
    q[(draw >= 0.8) & (draw < 0.9), 0] = ALL_T            # at or above the last
    q[(draw >= 0.9), :] = rng.integers(0, 1 << 62, size=((draw >= 0.9).sum(), nw))
    q = q.reshape(b, w, nw)
    rep = rng.random((b, w)) < 0.15
    rep[:, 0] = False
    src = (rng.random((b, w)) * np.arange(w)).astype(np.int64)
    q = np.where(rep[..., None], np.take_along_axis(q, src[..., None], 1), q)
    q[2] = q[2, 0]                                        # a read of one key
    ok = rng.random((b, w)) < 0.85
    q[4, ::2, 0] = ALL_T                                  # the all-T word, gated and not
    ok[4, ::4] = False
    ok[3] = False
    words = tuple(np.ascontiguousarray(q[..., i]) for i in range(nw))
    return tuple(np.ascontiguousarray(keys[:, i]) for i in range(nw)), sid, gc, words, ok


@pytest.mark.parametrize("chunk", [probe_sort2.H4_CHUNK, 7], ids=["reads a block", "chunked read"])
@pytest.mark.parametrize("kind", H4_KINDS)
@pytest.mark.parametrize("nw", [1, 2, 3])
def test_sort_probe_model_matches_plain_join(nw, kind, chunk):
    """The model of kernel H4 gives the plain join's four outputs; its rows
    are each key's run's last row (``np.searchsorted`` on word 0, then
    narrowed on each later word)."""
    rng = np.random.default_rng(nw * 100 + H4_KINDS.index(kind) * 10 + (chunk == 7))
    tw, sid, gc, qw, ok = _h4_case(rng, nw, kind)
    tab = SortedTableDev(tuple(map(torch.from_numpy, tw)), torch.from_numpy(sid),
                         torch.from_numpy(gc))
    want = probe_dedupe_sorted_words(tab, tuple(map(torch.from_numpy, qw)),
                                     torch.from_numpy(ok))
    got = sort_probe_model(tw, sid, gc, qw, ok, chunk)
    _assert_equal(got[:4], [x.numpy() for x in want])
    rows = _run_rows(tw, qw) if sid.size else np.full(ok.shape, -1)
    np.testing.assert_array_equal(got[4], np.where(ok, rows, -1))
    hit, fo = got[0], got[3]
    if kind == "empty":
        assert not hit.any()
    else:
        assert hit.any() and (ok & ~hit).any() and (hit & ~fo).any()
        assert fo[2].sum() == hit[2].any() and not hit[3].any()


def test_probe_dedupe_sorted_words_takes_the_plain_join_on_the_cpu(monkeypatch):
    """CPU tensors never reach kernel H4 or the kernel library."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route reached the kernel")

    monkeypatch.setattr(probe_sort2, "sort_probe", refuse)
    monkeypatch.setattr(probe_sort2, "load_library", refuse)
    tw, sid, gc, qw, ok = _h4_case(np.random.default_rng(5), 2, "repeated")
    tab = SortedTableDev(tuple(map(torch.from_numpy, tw)), torch.from_numpy(sid),
                         torch.from_numpy(gc))
    args = (tab, tuple(map(torch.from_numpy, qw)), torch.from_numpy(ok))
    got = probe_dedupe_sorted_words(*args)
    want = probe_sort2.probe_dedupe_sorted_words_plain(*args)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert got[0].any()


@pytest.mark.parametrize("bad,match", [
    ("cpu", "unsupported device"), ("words", "query words against a table of"),
    ("dtype", "table sid must be torch.int32"), ("shape", "query word must be"),
    ("strided", "query word must be contiguous")])
def test_sort_probe_refuses_what_the_kernel_does_not_take(bad, match):
    """``sort_probe`` (the kernel's launcher) raises before any launch: on
    a CPU tensor, on a word count unlike the table's, on a dtype, a shape
    or a layout it does not take."""
    tw, sid, gc, qw, ok = _h4_case(np.random.default_rng(6), 2, "distinct")
    tab = SortedTableDev(tuple(map(torch.from_numpy, tw)), torch.from_numpy(sid),
                         torch.from_numpy(gc))
    words, query_ok = tuple(map(torch.from_numpy, qw)), torch.from_numpy(ok)
    if bad == "words":
        words = words[:1]
    elif bad == "dtype":
        tab = tab._replace(sid=tab.sid.to(torch.int64))
    elif bad == "shape":
        query_ok = query_ok[:, :-1].contiguous()
    elif bad == "strided":
        words = (words[0], torch.empty_like(words[1]).t().contiguous().t().copy_(words[1]))
    launches = probe_sort2.sort_probe.launches
    with pytest.raises(ValueError, match=match):
        probe_sort2.sort_probe(tab, words, query_ok)
    assert probe_sort2.sort_probe.launches == launches
