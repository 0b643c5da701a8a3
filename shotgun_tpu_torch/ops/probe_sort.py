"""The key-sorted k-mer table of the sort-join probe (counterpart of
``shotgun_tpu/ops/probe_sort.py:25-67``, its ``SortedTableDev`` and
``SortedTableDevW`` in one type).

A key is the words of ``ops.encode.word_spans``: int64 base-4 numbers of
at most 31 bases, most significant first.  At k <= 31 that is one word,
``hi << 32 | lo`` of the JAX package's (lo, hi) uint32 pair.  Rows are in
key order, with the row's genome-set id and genome count.  A table made
here holds live rows only: the JAX package's dead rows (``gc == 0``: the
shape-bucket pads of its ``reference.py:629-640`` and the invalid windows
of its device build) are dropped when the table is made, so the probe
needs no pad contract.  Rows with equal keys may repeat (the JAX device
build keeps one row per occurrence); equal keys carry equal payloads, and
the probe reads any one of them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from shotgun_tpu_torch.ops.encode import word_spans


class SortedTableDev(NamedTuple):
    """Device tensors of the key-sorted table."""

    words: Tuple[torch.Tensor, ...]  # int64 [U] each, < 2**62, most significant first
    sid: torch.Tensor                # int32 [U] genome-set ids
    gc: torch.Tensor                 # int32 [U] genome counts, > 0


def key_words_from_u32(words_u32: np.ndarray, k: int) -> Tuple[np.ndarray, ...]:
    """[N, nw] uint32 key words, least significant first (the host
    index's ``kmer_words``), -> the k-mers' int64 words of
    ``ops.encode.word_spans``, most significant first."""
    n, nw = words_u32.shape
    w64 = words_u32.astype(np.uint64)
    out = []
    for start, bases in word_spans(k):
        lo_bit = 2 * (k - start - bases)   # the word's lowest bit in the key
        i, s = divmod(lo_bit, 32)
        val = w64[:, i] >> np.uint64(s)
        for j in (i + 1, i + 2):
            if j < nw and 32 * (j - i) - s < 64:
                val |= w64[:, j] << np.uint64(32 * (j - i) - s)
        out.append((val & np.uint64((1 << (2 * bases)) - 1)).astype(np.int64))
    return tuple(out)


def sorted_table_host(index) -> Tuple[Tuple[np.ndarray, ...], np.ndarray, np.ndarray]:
    """(words, sid int32, gc int32) of a ``KmerIndex`` of any k >= 1, whose
    rows are in key order (counterpart of the JAX package's
    ``sorted_table_host`` and ``sorted_table_host_words``): one word at
    k <= 31."""
    return (key_words_from_u32(index.kmer_words, index.k),
            index.set_id.astype(np.int32), index.genome_counts().astype(np.int32))


def sorted_table(words: Sequence, sid, gc, device: torch.device) -> SortedTableDev:
    """A ``SortedTableDev`` on ``device`` from key-ordered columns (numpy
    arrays or tensors; ``words`` one column a word), without the rows
    whose genome count is 0."""
    words = [torch.as_tensor(x) for x in words]
    sid, gc = torch.as_tensor(sid), torch.as_tensor(gc)
    live = gc > 0
    if not bool(live.all()):
        words, sid, gc = [x[live] for x in words], sid[live], gc[live]
    return SortedTableDev(words=tuple(x.to(device, torch.int64) for x in words),
                          sid=sid.to(device, torch.int32),
                          gc=gc.to(device, torch.int32))
