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

The probe numbers a slot ``bucket * slots + s`` in int32 below the stash's
positions, which start at ``STASH_POS_BASE``, so no table may have more
slots than that: a build that would pass it raises ``SlotLimitError``
(where the JAX package's uint32 positions wrap, ``shotgun_tpu/ops/probe.py:125``).
That is a 16-slot table of more than ``slot_limit_keys(16)`` keys
(268,435,459) and a 4-slot one of more than ``slot_limit_keys(4)``
(67,108,864), or one that a stash doubling takes past the limit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from shotgun_tpu_torch.ops.encode import mix32_np

SLOTS = 4
EMPTY = np.uint32(0xFFFFFFFF)
STASH_CAP = 64
#: a stash hit's slot position is STASH_POS_BASE + its row; table slots
#: are numbered below it
STASH_POS_BASE = 0x7FFF0000

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


class SlotLimitError(ValueError):
    """A table would have more slots than the probe can number."""


def first_buckets(u: int, slots: int) -> int:
    """``build_probe_table``'s first bucket count for ``u`` keys."""
    return _next_pow2(max(int(u / _TARGET_LAMBDA.get(slots, 1.0)), 1))


def slots_fit(n_buckets: int, slots: int) -> bool:
    """Whether every slot of the table has a position below the stash's."""
    return n_buckets * slots <= STASH_POS_BASE


def check_slot_limit(n_buckets: int, slots: int) -> None:
    """Raise ``SlotLimitError`` unless ``slots_fit``."""
    if not slots_fit(n_buckets, slots):
        raise SlotLimitError(
            f"a {slots}-slot hash table of {n_buckets} buckets has "
            f"{n_buckets * slots} slots, more than the probe numbers "
            f"({STASH_POS_BASE:#x}); use the sort join (SHOTGUN_TPU_PROBE=sort)")


def slot_limit_keys(slots: int) -> int:
    """The most keys whose first table (``first_buckets``) fits the
    probe's slot limit."""
    lo, hi = 1, 1 << 40  # first_buckets(lo) fits, first_buckets(hi) does not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if slots_fit(first_buckets(mid, slots), slots):
            lo = mid
        else:
            hi = mid
    return lo


def build_probe_table(
    kmer_lo: np.ndarray,
    kmer_hi: np.ndarray,
    set_id: np.ndarray,
    genome_count: np.ndarray,
    slots_per_bucket: int = SLOTS,
    stash_cap: int = STASH_CAP,
) -> ProbeTable:
    """Place every distinct k-mer in its primary bucket, overflow to the
    stash; ``SlotLimitError`` when the table, first or doubled, would pass
    the probe's slot limit."""
    u = kmer_lo.size
    n_buckets = first_buckets(u, slots_per_bucket)
    while True:
        check_slot_limit(n_buckets, slots_per_bucket)
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
