"""The port's hash table build and probe (kernel H2's plain path) against
the JAX package's: ``index.hashtable.build_probe_table``,
``ops.probe.probe_kmers`` (the XLA reduction) and ``resolve_rows_pallas``
in interpret mode.  Exact equality throughout."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from shotgun_tpu.index import hashtable as jht
from shotgun_tpu.ops import encode as jenc
from shotgun_tpu.ops.pallas.kernels import resolve_rows_pallas
from shotgun_tpu.ops.probe import probe_kmers as jax_probe_kmers
from shotgun_tpu_torch import convert
from shotgun_tpu_torch.index import hashtable as tht
from shotgun_tpu_torch.ops.probe import (
    HashTableDev,
    hash_probe,
    hash_probe_plain,
    probe_kmers,
)

import chip_smoke

torch.set_num_threads(2)
CPU = torch.device("cpu")
EMPTY = np.uint32(0xFFFFFFFF)


def _random_keys(rng, n):
    keys = np.unique(rng.integers(0, 1 << 62, size=n, dtype=np.int64))
    return keys[rng.permutation(keys.size)]


def _columns(keys, rng):
    lo = (keys & 0xFFFFFFFF).astype(np.uint32)
    hi = (keys >> 32).astype(np.uint32)
    sid = rng.integers(0, 500, size=keys.size).astype(np.int32)
    gc = rng.integers(1, 6, size=keys.size).astype(np.int32)
    return lo, hi, sid, gc


def _planted_table(rng, slots, n_base, n_planted):
    """Keys of which ``n_planted`` share one bucket of the final table,
    so more than ``slots`` of them overflow into the stash."""
    base = _random_keys(rng, n_base)
    n_total = base.size + n_planted
    lam = jht._TARGET_LAMBDA[slots]
    nb = jht._next_pow2(max(int(n_total / lam), 1))
    cand = _random_keys(rng, 1 << 21)
    lo, hi, _, _ = _columns(cand, rng)
    bucket = jenc.mix32(lo, hi, np) & np.uint32(nb - 1)
    same = cand[bucket == bucket[0]]
    assert same.size >= n_planted
    keys = np.concatenate([base, same[:n_planted]])
    keys = np.unique(keys)[: n_total]
    return keys[rng.permutation(keys.size)]


def _query_keys(rng, table_keys, b, w):
    """[b, w] queries: table keys (some repeated) and keys the table lacks."""
    present = rng.choice(table_keys, size=(b, w))
    absent = rng.integers(0, 1 << 62, size=(b, w), dtype=np.int64)
    return np.where(rng.random((b, w)) < 0.7, present, absent)


def _jax_probe(pt_table, pt_stash, keys):
    lo = jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32))
    hi = jnp.asarray((keys >> 32).astype(np.uint32))
    return [np.asarray(x) for x in jax_probe_kmers(
        jnp.asarray(pt_table), jnp.asarray(pt_stash), lo, hi)]


@pytest.mark.parametrize("slots", [4, 16])
def test_build_probe_table_matches_jax(slots):
    rng = np.random.default_rng(slots)
    lo, hi, sid, gc = _columns(_planted_table(rng, slots, 3000, 24), rng)
    jt = jht.build_probe_table(lo, hi, sid, gc, slots_per_bucket=slots)
    tt = tht.build_probe_table(lo, hi, sid, gc, slots_per_bucket=slots)
    assert (tt.n_buckets, tt.num_keys) == (jt.n_buckets, jt.num_keys)
    assert jt.stash.shape[0] > 0
    np.testing.assert_array_equal(tt.stash, jt.stash)
    # the JAX build leaves the key words of empty slots uninitialised:
    # every set-id word, and every word of an occupied slot, must agree
    np.testing.assert_array_equal(tt.table[..., 2], jt.table[..., 2])
    occupied = jt.table[..., 2] != EMPTY
    np.testing.assert_array_equal(tt.table[occupied], jt.table[occupied])


@pytest.mark.parametrize("slots", [4, 16])
def test_probe_matches_jax_with_stash(slots):
    rng = np.random.default_rng(10 + slots)
    keys = _planted_table(rng, slots, 2000, 30)
    lo, hi, sid, gc = _columns(keys, rng)
    pt = tht.build_probe_table(lo, hi, sid, gc, slots_per_bucket=slots)
    assert pt.stash.shape[0] > 0
    queries = _query_keys(rng, keys, 24, 50)
    want = _jax_probe(pt.table, pt.stash, queries)

    tab = convert.hash_table(pt, CPU)
    got = [x.numpy() for x in probe_kmers(tab.table, tab.stash,
                                          torch.from_numpy(queries))]
    for g, w, name in zip(got, want, ("hit", "set_id", "genome_count", "slot_pos")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got[3] >= 0x7FFF0000).any()       # some keys resolved in the stash
    assert (~got[0]).any() and got[0].any()


def test_probe_reduction_is_min_max_min_over_duplicate_slots():
    """A key held in two slots and twice in the stash: the min set id, max
    genome count and min slot position win, as in the XLA reduction (the
    Pallas kernel would keep the last matching slot instead)."""
    rng = np.random.default_rng(3)
    keys = _random_keys(rng, 200)
    lo, hi, sid, gc = _columns(keys, rng)
    pt = tht.build_probe_table(lo, hi, sid, gc, slots_per_bucket=4)
    table = pt.table.copy()
    target = keys[:8]
    tl, th = (target & 0xFFFFFFFF).astype(np.uint32), (target >> 32).astype(np.uint32)
    bidx = jenc.mix32(tl, th, np) & np.uint32(pt.n_buckets - 1)
    for i, b in enumerate(bidx):
        free = np.flatnonzero(table[b, :, 2] == EMPTY)
        table[b, free[-1]] = (tl[i], th[i], 1000 + i, 9)
    stash = np.array([[tl[0], th[0], 3, 11], [tl[0], th[0], 7, 2],
                      [tl[1], th[1], 5000, 1]], dtype=np.uint32)
    queries = np.concatenate([target, keys[8:40]]).reshape(4, 10)
    want = _jax_probe(table, stash, queries)
    got = [x.numpy() for x in probe_kmers(
        *convert.hash_table(HashTableDev(table, stash), CPU), torch.from_numpy(queries))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_probe_matches_pallas_resolve_on_well_formed_rows():
    rng = np.random.default_rng(4)
    keys = _random_keys(rng, 1500)
    lo, hi, sid, gc = _columns(keys, rng)
    pt = tht.build_probe_table(lo, hi, sid, gc, slots_per_bucket=16)
    assert pt.stash.shape[0] == 0
    queries = _query_keys(rng, keys, 16, 40)
    qlo = (queries & 0xFFFFFFFF).astype(np.uint32)
    qhi = (queries >> 32).astype(np.uint32)
    bidx = (jenc.mix32(qlo, qhi, np) & np.uint32(pt.n_buckets - 1)).astype(np.int32)
    sid_p, gc_p, pos_p = [np.asarray(x) for x in resolve_rows_pallas(
        jnp.asarray(pt.table[bidx]), jnp.asarray(bidx), jnp.asarray(qlo),
        jnp.asarray(qhi), interpret=True)]

    tab = convert.hash_table(pt, CPU)
    sid_t, gc_t, pos_t = [x.numpy() for x in hash_probe(
        tab.table, tab.stash, torch.from_numpy(queries))]
    hit = sid_p != EMPTY
    np.testing.assert_array_equal(sid_t >= 0, hit)
    np.testing.assert_array_equal(sid_t[hit], sid_p[hit].astype(np.int32))
    np.testing.assert_array_equal(gc_t[hit], gc_p[hit].astype(np.int32))
    np.testing.assert_array_equal(pos_t[hit], pos_p[hit].astype(np.int32))
    np.testing.assert_array_equal(pos_t[~hit], -1)
    np.testing.assert_array_equal(gc_t[~hit], 0)


def test_plain_probe_chunks_agree(monkeypatch):
    """The plain probe's chunking over windows changes nothing."""
    from shotgun_tpu_torch.ops import probe as tprobe

    rng = np.random.default_rng(6)
    keys = _planted_table(rng, 4, 500, 12)
    pt = tht.build_probe_table(*_columns(keys, rng), slots_per_bucket=4)
    tab = convert.hash_table(pt, CPU)
    queries = torch.from_numpy(_query_keys(rng, keys, 7, 33))
    whole = hash_probe_plain(tab.table, tab.stash, queries)
    monkeypatch.setattr(tprobe, "_PLAIN_CHUNK", 10)
    chunked = hash_probe_plain(tab.table, tab.stash, queries)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["table_dtype", "not_pow2", "stash_rows", "key_dtype"])
def test_hash_probe_rejects_bad_input(bad):
    table = torch.zeros((8, 4, 4), dtype=torch.int32)
    stash = torch.zeros((0, 4), dtype=torch.int32)
    keys = torch.zeros((2, 3), dtype=torch.int64)
    if bad == "table_dtype":
        table = table.to(torch.int64)
    elif bad == "not_pow2":
        table = torch.zeros((6, 4, 4), dtype=torch.int32)
    elif bad == "stash_rows":
        stash = torch.zeros((65, 4), dtype=torch.int32)
    else:
        keys = keys.to(torch.int32)
    with pytest.raises(ValueError):
        hash_probe(table, stash, keys)


def test_hash_probe_refuses_slot_positions_past_the_stash_range():
    """Flat slot positions bucket * slots + s must stay below the stash's
    0x7FFF0000: a larger table raises on the CPU path as on the CUDA one
    (expanded tensors: no memory behind them)."""
    keys = torch.zeros((2, 3), dtype=torch.int64)
    stash = torch.zeros((0, 4), dtype=torch.int32)
    for n_buckets, slots in ((1 << 27, 16), (1 << 29, 4), (1 << 16, 32768)):
        table = torch.zeros((1, 1, 4), dtype=torch.int32).expand(n_buckets, slots, 4)
        with pytest.raises(ValueError, match="stash"):
            hash_probe(table, stash, keys)
    # 0x7FFF0000 slots exactly: the last position is 0x7FFEFFFF, still below
    # (every slot EMPTY; the plain probe gathers rows of the stride-0 view)
    empty_row = torch.tensor([[[0, 0, -1, 0]]], dtype=torch.int32)
    table = empty_row.expand(1 << 16, 32767, 4)
    sid, gc, pos = hash_probe(table, stash, keys)
    assert bool((sid == -1).all()) and bool((pos == -1).all())


# --- a numpy model of kernel H2's lane mapping (ops/kernels/csrc/hash_probe.cu):
# a warp takes 32 consecutive probes; in iteration j the group of `slots`
# lanes starting at lane g reads the row of probe g + j (its key and bucket
# by shuffle from lane g + j), lane l of the group slot l; a ballot gives
# each group its matching slots, and lane g + j keeps the lowest as the
# position and takes set id and genome count from each matching lane, in
# rounds while any group has a match left; each lane then compares its own
# key against the stash and lane i stores probe i.  Its index math is the
# kernel's, line for line.

_THREADS = 256


def h2_model(table: np.ndarray, stash: np.ndarray, keys: np.ndarray):
    """(sid, gc, pos) int32 of kernel H2 on uint32 ``table`` [nb, slots, 4],
    uint32 ``stash`` [s, 4] and int64 ``keys`` [n], as its warps compute
    them: warp w of block b takes the 32 probes from b * 256 + 32 * w."""
    nb, slots = table.shape[:2]
    n = keys.size
    blocks = -(-n // _THREADS)
    bases = (np.arange(blocks)[:, None] * _THREADS
             + 32 * np.arange(_THREADS // 32)).reshape(-1)
    bases = bases[bases < n]                                # whole warps past n leave
    lane = np.arange(32)
    live = np.minimum(n - bases, 32)[:, None]              # [C, 1]
    valid = lane[None, :] < live                            # [C, 32]
    t = bases[:, None] + lane[None, :]
    key = np.where(valid, keys[np.minimum(t, n - 1)], 0).astype(np.uint64)
    lo = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (key >> np.uint64(32)).astype(np.uint32)
    bucket = jenc.mix32(lo, hi, np) & np.uint32(nb - 1)
    group = lane & ~(slots - 1)
    slot = lane & (slots - 1)
    sid = np.full(lo.shape, EMPTY, np.uint32)
    gc = np.zeros(lo.shape, np.uint32)
    pos = np.full(lo.shape, EMPTY, np.uint32)
    for j in range(slots):                                  # the depth only reorders loads
        src = group | j                                     # shuffle source lane
        b = bucket[:, src]
        e = table[b, slot[None, :]]                         # [C, 32, 4]
        e = np.where((src[None, :] < live)[..., None], e,
                     np.array([0, 0, EMPTY, 0], np.uint32))
        m = (e[..., 0] == lo[:, src]) & (e[..., 1] == hi[:, src]) & (e[..., 2] != EMPTY)
        # __ballot_sync, shifted to each group's bits
        ball = (m.astype(np.uint64) << lane.astype(np.uint64)).sum(axis=1)
        bits = ((ball[:, None] >> group.astype(np.uint64))
                & np.uint64((1 << slots) - 1)).astype(np.uint32)
        owner = (slot == j)[None, :]                        # lane g + j owns probe g + j

        def ffs(x):                                          # __ffs(x) - 1 where x != 0
            low = np.zeros(x.shape, np.int64)
            for s in reversed(range(slots)):
                low = np.where((x >> np.uint32(s)) & np.uint32(1), s, low)
            return low

        first = owner & (bits != 0)
        pos = np.where(first, bucket * np.uint32(slots) + ffs(bits).astype(np.uint32), pos)
        while (bits != 0).any():                            # __any_sync rounds
            src_lane = group[None, :] | ffs(bits)           # shuffle source lane
            z = np.take_along_axis(e[..., 2], src_lane, axis=1)
            w = np.take_along_axis(e[..., 3], src_lane, axis=1)
            take = owner & (bits != 0)
            sid = np.where(take, np.minimum(sid, z), sid)
            gc = np.where(take, np.maximum(gc, w), gc)
            bits = bits & (bits - np.uint32(1))
    # the stash: four key_lo words at a time, then the full compare of
    # those entries (words past the stash are whatever shared memory holds)
    s_lo = np.concatenate([stash[:, 0], lo.reshape(-1)[:3]])
    for i in range(0, stash.shape[0], 4):
        quick = (s_lo[i: i + 4][None, None, :] == lo[..., None]).any(axis=2)
        for q in range(i, min(i + 4, stash.shape[0])):
            e = stash[q]
            m = quick & (e[0] == lo) & (e[1] == hi)
            sid = np.where(m, np.minimum(sid, e[2]), sid)
            gc = np.where(m, np.maximum(gc, e[3]), gc)
            pos = np.where(m, np.minimum(pos, np.uint32(0x7FFF0000 + q)), pos)
    out = [np.full(n, 12345, np.int32) for _ in range(3)]   # unwritten shows
    hit = sid != EMPTY
    for o, v in zip(out, (np.where(hit, sid, -1), gc, np.where(hit, pos, -1))):
        o[t[valid]] = v.astype(np.int64)[valid].astype(np.int32)
    return out


@pytest.mark.parametrize("slots", [4, 16])
@pytest.mark.parametrize("stash_n", [0, 1, 64])
def test_h2_model_equals_plain_and_jax(slots, stash_n):
    """The kernel's lane mapping (numpy model) on the edge tables of
    ``chip_smoke.py`` phase 4 (keys in the first and last slot of a full
    bucket, in buckets 0 and n_buckets - 1, twice in a row and twice in
    the stash), at the edge probe counts, against ``hash_probe_plain``
    and the JAX ``probe_kmers``."""
    rng = np.random.default_rng(100 * slots + stash_n)
    table, stash, specials = chip_smoke.edge_table(rng, slots)
    stash = stash[:stash_n]
    tab = HashTableDev(torch.from_numpy(table.view(np.int32)),
                       torch.from_numpy(stash.view(np.int32)))
    n_all = (1, 31, 32, 33, 255, 257, 1200)
    queries = [chip_smoke.edge_queries(rng, table, specials, n) for n in n_all]
    for q in queries:
        got = h2_model(table, stash, q)
        want = [x.numpy() for x in hash_probe_plain(*tab, torch.from_numpy(q))]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # one JAX compile a case: every query set as one row
    flat = np.concatenate(queries)
    _, sid, gc, pos = _jax_probe(table, stash, flat[None, :])
    for g, w in zip(h2_model(table, stash, flat), (sid, gc, pos)):
        np.testing.assert_array_equal(g, w[0])


def test_h2_edge_table_holds_each_edge():
    """The edge tables hold what their doc says, so the chip's edge cases
    and the model tests really reach those slots, buckets and merges."""
    for slots in (4, 16):
        rng = np.random.default_rng(slots)
        table, stash, specials = chip_smoke.edge_table(rng, slots)
        nb = table.shape[0]
        assert stash.shape == (64, 4)
        sid, gc, pos = [x.numpy() for x in hash_probe_plain(
            torch.from_numpy(table.view(np.int32)), torch.from_numpy(stash.view(np.int32)),
            torch.from_numpy(specials))]
        first, last, b0, blast, dup, over, alone = range(7)
        assert pos[first] % slots == 0 and pos[last] % slots == slots - 1
        assert pos[first] // slots == pos[last] // slots      # one full bucket
        assert pos[b0] // slots == 0 and pos[blast] // slots == nb - 1
        assert pos[over] == 0x7FFF0000 and pos[alone] >= 0x7FFF0000
        held = table[..., 0].astype(np.int64) | table[..., 1].astype(np.int64) << 32
        held = np.where(table[..., 2] != EMPTY, held, -1)
        assert ((held == specials[dup]).sum(axis=1) == 2).any()  # twice in one row
        skeys = stash[:, 0].astype(np.int64) | stash[:, 1].astype(np.int64) << 32
        for k in (b0, over):  # twice in the stash, beside a table match or alone
            assert (skeys == specials[k]).sum() == 2
        assert (sid >= 0).all()
