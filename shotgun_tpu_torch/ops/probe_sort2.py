"""Sort-join probe with the within-read first-occurrence dedupe
(counterpart of ``shotgun_tpu/ops/probe_sort2.py:163-354``,
``probe_dedupe_sorted`` and ``probe_dedupe_sorted_words``, in one join
over the key words of ``ops.probe_sort``: one word at k <= 31).

``probe_dedupe_sorted_words`` is the wrapper: a CUDA tensor launches
kernel H4 ``sort_probe`` (``ops/kernels/csrc/sort_probe.cu``), which
finds each window's row by a binary search in the resident sorted words
and dedupes each read in the same launch; a CPU tensor takes
``probe_dedupe_sorted_words_plain``, the join below.

The plain join merges the table and the batch in one stable sort, so each
run of equal keys holds its table rows first, then its queries in
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
significant word first: ceil(k / 31) sorts.  H4 computes the same row
without the sort: the count of table rows whose key is at most the
window's, less one.

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

import ctypes
from collections import Counter
from typing import Sequence, Tuple

import torch

from shotgun_tpu_torch.ops.kernels.build import check_status, load_library
from shotgun_tpu_torch.ops.probe_sort import SortedTableDev

#: windows whose rows a block of H4 holds at once (``kChunk`` of
#: sort_probe.cu): a block owns ``H4_CHUNK // W`` whole reads, or one read
#: walked in chunks of ``H4_CHUNK`` windows
H4_CHUNK = 1024
#: the most key words H4 takes (``kWide``: k <= 7440)
H4_MAX_WORDS = 240

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def probe_dedupe_sorted_words_plain(
    tab: SortedTableDev,
    words: Sequence[torch.Tensor],  # int64 [B, W] each, most significant first
                                    # (contiguous, as encode_words makes them:
                                    # flattening each is a view)
    query_ok: torch.Tensor,         # bool [B, W] windows that passed validity + MKQ
) -> Outputs:
    """Plain PyTorch version of kernel H4: the join of the module doc.
    (hit, set_id, genome_count, first_occ), each [B, W].

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


def sort_probe(tab: SortedTableDev, words: Sequence[torch.Tensor],
               query_ok: torch.Tensor) -> Outputs:
    """Kernel H4 on CUDA tensors: ``probe_dedupe_sorted_words_plain``'s
    outputs, bit for bit, from one launch on the current stream (counted
    in ``sort_probe.launches``, and in ``sort_probe.launches_by_mode``
    under "<n> word(s)").  Raises on what the kernel does not take."""
    device, shape = query_ok.device, tuple(query_ok.shape)
    nw, u = len(words), tab.sid.shape[0]
    if not 1 <= nw <= H4_MAX_WORDS or nw != len(tab.words):
        raise ValueError(f"sort_probe: {nw} query words against a table of "
                         f"{len(tab.words)}; the kernel takes 1 to {H4_MAX_WORDS} "
                         f"(k <= {31 * H4_MAX_WORDS})")
    if query_ok.dtype != torch.bool or len(shape) != 2:
        raise ValueError(f"query_ok must be bool [B, W], got {query_ok.dtype} {shape}")
    for x, name, dtype, want in (
            *((q, "query word", torch.int64, shape) for q in words),
            *((t, "table word", torch.int64, (u,)) for t in tab.words),
            (tab.sid, "table sid", torch.int32, (u,)),
            (tab.gc, "table gc", torch.int32, (u,))):
        if x.dtype != dtype or tuple(x.shape) != want or x.device != device:
            raise ValueError(f"sort_probe: {name} must be {dtype} {want} on {device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"sort_probe: {name} must be contiguous")
    if not query_ok.is_contiguous():
        raise ValueError("sort_probe: query_ok must be contiguous")
    if device.type != "cuda":
        raise ValueError(f"sort_probe: unsupported device {device}")
    b, w = shape
    hit = torch.empty(shape, dtype=torch.bool, device=device)
    sid = torch.empty(shape, dtype=torch.int32, device=device)
    gc = torch.empty(shape, dtype=torch.int32, device=device)
    first = torch.empty(shape, dtype=torch.bool, device=device)
    ptrs = ctypes.c_void_p * nw
    lib = load_library()
    # the launch sets the device; the guard gives the caller's back
    with torch.cuda.device(device):
        status = lib.stt_sort_probe(
            ptrs(*(t.data_ptr() for t in tab.words)), ptrs(*(q.data_ptr() for q in words)),
            nw, tab.sid.data_ptr(), tab.gc.data_ptr(), u, query_ok.data_ptr(), b, w,
            hit.data_ptr(), sid.data_ptr(), gc.data_ptr(), first.data_ptr(),
            device.index, torch.cuda.current_stream(device).cuda_stream)
    check_status(lib, status, "sort_probe")
    sort_probe.launches += 1
    sort_probe.launches_by_mode[f"{nw} word" + "s" * (nw > 1)] += 1
    return hit, sid, gc, first


sort_probe.launches = 0
sort_probe.launches_by_mode = Counter()


def probe_dedupe_sorted_words(
    tab: SortedTableDev,
    words: Sequence[torch.Tensor],  # int64 [B, W] each, most significant first
    query_ok: torch.Tensor,         # bool [B, W] windows that passed validity + MKQ
) -> Outputs:
    """(hit, set_id, genome_count, first_occ), each [B, W] (see
    ``probe_dedupe_sorted_words_plain``).  A CUDA tensor launches kernel
    H4 (``sort_probe``) or raises; a CPU tensor takes the plain join."""
    if query_ok.device.type == "cpu":
        return probe_dedupe_sorted_words_plain(tab, words, query_ok)
    return sort_probe(tab, words, query_ok)


def probe_dedupe_sorted(
    tab: SortedTableDev,
    keys: torch.Tensor,       # int64 [B, W] window keys, k <= 31
    query_ok: torch.Tensor,   # bool [B, W]
) -> Outputs:
    """``probe_dedupe_sorted_words`` of one-word keys."""
    return probe_dedupe_sorted_words(tab, (keys,), query_ok)
