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
