"""Sort-join probe with the within-read first-occurrence dedupe
(counterpart of ``shotgun_tpu/ops/probe_sort2.py:163-354``,
``probe_dedupe_sorted`` and ``probe_dedupe_sorted_words``, in one join
over the key words of ``ops.probe_sort``: one word at k <= 31).

One stable sort merges the table keys and the batch's window keys, so
each run of equal keys holds its table rows first, then its queries in
original (read, window) order:

  1. tag: the last word of a table row ``word << 1`` (tag 0), of a query
     that passed the gates ``word << 1 | 1`` (tag 1); a gated query has
     every word -1;
  2. a prefix count of table rows gives, per sorted position, the last
     table row at or before it (the table's rows keep their order);
  3. a query is a within-read duplicate when its sorted predecessor is a
     query with the same key from the same read;
  4. that row and the duplicate flag go back to [B, W] by the sort's
     permutation; a query hits when it passed the gates and the row holds
     its key, and then gathers the row's set id and genome count.

A stable sort by the word tuple is a chain of stable sorts, least
significant word first: ceil(k / 31) sorts.

The JAX form packs the payload into carry words restored by a second sort
(``_carry_layout`` .. ``_restore``, its ``:60-160``) because a gather costs
about 30 ns a row on the TPU; on the GPU one gather and one scatter do.
Its genome counts saturate at 2**16 - 1 (its ``:85``); the gather here is
exact, as the JAX hash probe is.

A word is < 2**62, so a tagged word fits an int64.  The all-T 31-mer is
2**62 - 1 and tags to int64 max, so a gated window cannot use int64 max
as its sentinel: it takes -1, below every table row, and its run holds
no table row.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from shotgun_tpu_torch.ops.probe_sort import SortedTableDev


def probe_dedupe_sorted_words(
    tab: SortedTableDev,
    words: Sequence[torch.Tensor],  # int64 [B, W] each, most significant first
    query_ok: torch.Tensor,         # bool [B, W] windows that passed validity + MKQ
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hit, set_id, genome_count, first_occ), each [B, W].

    ``hit``: the window passed ``query_ok`` and its key is in the table.
    ``first_occ``: the first hit window of each distinct key in its read.
    Misses have set_id -1 and genome_count 0."""
    b, w = words[0].shape
    dev = words[0].device
    u = tab.sid.shape[0]
    if u == 0:
        return (torch.zeros((b, w), dtype=torch.bool, device=dev),
                torch.full((b, w), -1, dtype=torch.int32, device=dev),
                torch.zeros((b, w), dtype=torch.int32, device=dev),
                torch.zeros((b, w), dtype=torch.bool, device=dev))

    ok = query_ok.reshape(-1)
    last = len(words) - 1
    cols = []
    for j, (tw, qw) in enumerate(zip(tab.words, words)):
        q = qw.reshape(-1)
        if j == last:
            tw, q = tw << 1, (q << 1) | 1
        cols.append(torch.cat([tw, torch.where(ok, q, -1)]))
    order = None
    for col in reversed(cols):
        top, by = torch.sort(col if order is None else col[order], stable=True)
        order = by if order is None else order[by]
    is_table = order < u
    # the table is key-sorted and enters the sort first, so its rows keep
    # their order: the count of table rows up to a position is one past
    # the last of them
    row = torch.cumsum(is_table, 0) - 1
    # a run is the rows whose words are equal but for the tag; the last
    # sort gave the most significant word in sorted order
    same = None
    for j, col in enumerate(cols):
        s = top if j == 0 else col[order]
        if j == last:
            s = s >> 1
        eq = s[1:] == s[:-1]
        same = eq if same is None else same & eq
    # same-key queries of one read are adjacent (stable sort, read-major
    # flat order), so a duplicate's predecessor is the same key's query
    qread = torch.div(order - u, w, rounding_mode="floor")
    dup = torch.zeros_like(is_table)
    dup[1:] = same & ~is_table[:-1] & (qread[1:] == qread[:-1])

    def restore(x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x)
        out[order] = x
        return out[u:].reshape(b, w)

    row, dup = restore(row), restore(dup)
    rowc = row.clamp(min=0)
    hit = query_ok & (row >= 0)
    for tw, qw in zip(tab.words, words):
        hit &= tw[rowc] == qw
    return (hit, torch.where(hit, tab.sid[rowc], -1),
            torch.where(hit, tab.gc[rowc], 0), hit & ~dup)


def probe_dedupe_sorted(
    tab: SortedTableDev,
    keys: torch.Tensor,       # int64 [B, W] window keys, k <= 31
    query_ok: torch.Tensor,   # bool [B, W]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``probe_dedupe_sorted_words`` of one-word keys."""
    return probe_dedupe_sorted_words(tab, (keys,), query_ok)
