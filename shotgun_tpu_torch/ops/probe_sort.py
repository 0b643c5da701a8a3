"""The key-sorted k-mer table of the sort-join probe (counterpart of
``shotgun_tpu/ops/probe_sort.py:25-67``, the k <= 31 form).

One int64 key per row, ``hi << 32 | lo`` of the JAX package's (lo, hi)
uint32 pair, in ascending order, with the row's genome-set id and genome
count.  A table made here holds live rows only: the JAX package's dead
rows (``gc == 0``: the shape-bucket pads of its ``reference.py:629-640``
and the invalid windows of its device build) are dropped when the table
is made, so the probe needs no pad contract.  Rows with equal keys may
repeat (the JAX device build keeps one row per occurrence); equal keys
carry equal payloads, and the probe reads any one of them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class SortedTableDev(NamedTuple):
    """Device tensors of the key-sorted table."""

    keys: torch.Tensor   # int64 [U] ascending, each < 2**62
    sid: torch.Tensor    # int32 [U] genome-set ids
    gc: torch.Tensor     # int32 [U] genome counts, > 0


def sorted_table_host(index) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(keys int64, sid int32, gc int32) of a k <= 31 ``KmerIndex``, whose
    rows are sorted by (hi, lo), i.e. by the int64 key."""
    keys = (index.kmer_hi.astype(np.int64) << 32) | index.kmer_lo.astype(np.int64)
    return (keys, index.set_id.astype(np.int32),
            index.genome_counts().astype(np.int32))


def sorted_table(keys, sid, gc, device: torch.device) -> SortedTableDev:
    """A ``SortedTableDev`` on ``device`` from key-sorted columns (numpy
    arrays or tensors), without the rows whose genome count is 0."""
    keys, sid, gc = (torch.as_tensor(x) for x in (keys, sid, gc))
    live = gc > 0
    if not bool(live.all()):
        keys, sid, gc = keys[live], sid[live], gc[live]
    return SortedTableDev(keys=keys.to(device, torch.int64),
                          sid=sid.to(device, torch.int32),
                          gc=gc.to(device, torch.int32))
