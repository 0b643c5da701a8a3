"""Single-gather hash table for k-mer probing (host build).

Jax-free copy of ``shotgun_tpu/index/hashtable.py:1-108``: the build must
give bit-identical ``table``/``stash`` arrays to the JAX package's for the
same index (tested), so a table built by either package probes the same.

Every key lives in its primary bucket ``mix32(lo, hi) & (n_buckets - 1)``;
keys that would overflow the bucket go to a small stash (at most
``STASH_CAP`` rows) that the probe compares against every window.  If the
stash would exceed its cap the table doubles and rebuilds.

Layout: ``table[n_buckets, slots, 4]`` uint32 rows of (key_lo, key_hi,
set_id, genome_count); empty slots have set_id == EMPTY.  Full 62-bit keys
are compared, never hashes, so collisions resolve exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from shotgun_tpu_torch.ops.encode import mix32_np

SLOTS = 4
EMPTY = np.uint32(0xFFFFFFFF)
STASH_CAP = 64

#: initial expected keys per bucket by slot width: narrow buckets at low
#: load for small tables, 16-slot buckets at 4 keys each (64 B/key) so
#: tables of 10^8 keys stay a few GB
_TARGET_LAMBDA = {2: 0.03, 4: 0.25, 8: 2.0, 16: 4.0}


@dataclass
class ProbeTable:
    """Host-resident table arrays, ready to ship to a device."""

    table: np.ndarray       # uint32 [n_buckets, slots, 4]
    n_buckets: int          # power of two
    stash: np.ndarray       # uint32 [stash_n, 4] overflow keys (maybe empty)
    num_keys: int


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def build_probe_table(
    kmer_lo: np.ndarray,
    kmer_hi: np.ndarray,
    set_id: np.ndarray,
    genome_count: np.ndarray,
    slots_per_bucket: int = SLOTS,
    stash_cap: int = STASH_CAP,
) -> ProbeTable:
    """Place every distinct k-mer in its primary bucket, overflow to the
    stash."""
    u = kmer_lo.size
    lam = _TARGET_LAMBDA.get(slots_per_bucket, 1.0)
    n_buckets = _next_pow2(max(int(u / lam), 1))
    while True:
        table, stash_idx = _try_build(
            kmer_lo, kmer_hi, set_id, genome_count, n_buckets, slots_per_bucket
        )
        if stash_idx.size <= stash_cap:
            break
        n_buckets *= 2
    stash = np.empty((stash_idx.size, 4), dtype=np.uint32)
    stash[:, 0] = kmer_lo[stash_idx]
    stash[:, 1] = kmer_hi[stash_idx]
    stash[:, 2] = set_id[stash_idx].astype(np.uint32)
    stash[:, 3] = genome_count[stash_idx].astype(np.uint32)
    return ProbeTable(
        table=table, n_buckets=n_buckets, stash=stash, num_keys=int(u)
    )


def _try_build(kmer_lo, kmer_hi, set_id, genome_count, n_buckets, slots):
    u = kmer_lo.size
    mask = np.uint32(n_buckets - 1)
    # zeroed (the JAX build leaves the key words of empty slots
    # uninitialised; the probe never reads them, since EMPTY never matches)
    table = np.zeros((n_buckets, slots, 4), dtype=np.uint32)
    table[..., 2] = EMPTY

    bucket = (mix32_np(kmer_lo, kmer_hi) & mask).astype(np.int64)
    order = np.argsort(bucket, kind="stable")
    b_sorted = bucket[order]
    # rank of each key within its bucket
    group_start = np.searchsorted(b_sorted, b_sorted)
    rank = np.arange(u, dtype=np.int64) - group_start
    placed = rank < slots
    pk = order[placed]
    table[b_sorted[placed], rank[placed], 0] = kmer_lo[pk]
    table[b_sorted[placed], rank[placed], 1] = kmer_hi[pk]
    table[b_sorted[placed], rank[placed], 2] = set_id[pk].astype(np.uint32)
    table[b_sorted[placed], rank[placed], 3] = genome_count[pk].astype(np.uint32)
    return table, order[~placed]
