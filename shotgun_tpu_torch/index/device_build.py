"""K-mer database build on the device (counterpart of
``shotgun_tpu/index/device_build.py``).

Builds what ``dumpalign`` needs of the index -- the key-sorted table of
distinct k-mers with their genome-set ids and genome counts, and the
genome-set member masks -- on the device, and the 16-slot hash table the
bucket probe (kernel H2) reads.  Only the multi-record sets' (set,
record) pairs, at most ``PMAX``, come back to the host.  The same table
assembly (``_place``) makes the 4- and 16-slot tables of a host-built or
loaded index on the device (``index_hash_table``), bit for bit the host
builder's.

  1. host: 2-bit pack of the genome codes and the list of N runs
     (``io.native.pack2``, numpy without the native library);
  2. window keys by kernel H1 over the packed genome as one row; a window
     is valid when it holds no N (an ``index_add_`` of +1/-1 run deltas,
     then a prefix sum) and crosses no record start;
  3. one stable sort of the valid keys: windows arrive in genome order,
     so records ascend inside each key group;
  4. per group, with segmented sums (a prefix sum minus the group's
     base): the genome count (distinct records) and, for groups of two
     or more records, two 32-bit set hashes summed over the records;
  5. ``torch.unique`` over the packed hash pair numbers the multi sets;
     singleton sets are their record id, multi sets follow at R + j.

Set ids may be numbered otherwise than the JAX package's; membership per
key is the same.  A hash collision cannot corrupt the output: every
multi group's genome count must equal the number of distinct records of
its set, which two merged sets exceed.  Where the JAX build returns None
and its callers build on the host, so does this one: k > 31, more than
``R_CAP`` records, more than ``NRUNS_CAP`` - 1 N runs, more than ``SMAX``
multi sets or ``PMAX`` multi pairs, or a collision.

Unlike the JAX build, the table keeps one row per distinct key (the
invalid windows and repeats are dropped here, not carried as dead rows),
and nothing is packed into one upload buffer: the TPU form does that to
save remote-call round trips.
"""

from __future__ import annotations

import os
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from shotgun_tpu_torch.io import native as _native
from shotgun_tpu_torch.index.hashtable import (
    _TARGET_LAMBDA,
    STASH_CAP,
    check_slot_limit,
    first_buckets as _first_buckets,
    slots_fit,
)
from shotgun_tpu_torch.ops.encode import M32, encode_window, mix32, pack_codes_2bit, split_key
from shotgun_tpu_torch.ops.probe_sort import host_key_words
from shotgun_tpu_torch.routes import JAX_ROUTES, device_routes
from shotgun_tpu_torch.utils.profiling import phase

#: record-count cap: a (set, record) pair packs as set * R_CAP + record
R_CAP = 4096
#: cap on distinct multi-record genome sets
SMAX = 4096
#: cap on (multi set, record) pairs fetched to the host
PMAX = 1 << 17
#: N-run cap of the JAX build's upload (one of its slots holds its pad)
NRUNS_CAP = 1 << 16

#: a device build's hash table: the host builder's 16-slot layout
HASH_SLOTS = 16
HASH_LAMBDA = _TARGET_LAMBDA[HASH_SLOTS]
HBM_BUDGET_ENV = "SHOTGUN_TPU_HASH_HBM_BUDGET"
#: the budget off a CUDA device (the JAX package's); a card's is
#: ``routes.card_routes``'s
HBM_BUDGET_DEFAULT = JAX_ROUTES.hash_budget
#: rows a step of the table assembly's chunked passes, and the most bytes
#: of temporaries such a step holds a row (``index_table_bytes``)
_CHUNK = 1 << 20
_CHUNK_ROW_BYTES = 128

_I64 = torch.int64


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32-style avalanche of uint32 values held in int64 (the JAX
    build's ``_mix32``, another function than ``ops.encode.mix32``)."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & M32
    return x ^ (x >> 16)


def _host_prep(genomes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(2-bit packed codes uint8 [ceil(g/4)], N runs int64 [n, 2] of
    (start, end)), or None past the N-run cap."""
    g = int(genomes.codes.size)
    gp = -(-g // 4) * 4
    codes2 = np.empty(gp // 4, dtype=np.uint8)
    runs = np.zeros(2 * (NRUNS_CAP - 1), dtype=np.int32)
    n_runs = _native.pack2(genomes.codes, gp, codes2, runs)
    if n_runs is None:  # no native library
        codes = np.zeros((1, gp), dtype=np.uint8)
        codes[0, :g] = genomes.codes & 3
        codes2[:] = pack_codes_2bit(codes)[0]
        edges = np.flatnonzero(np.diff(np.concatenate(
            [[False], genomes.codes >= 4, [False]]).astype(np.int8)))
        n_runs = edges.size // 2
        if n_runs > NRUNS_CAP - 1:
            return None
        runs[: edges.size] = edges
    elif n_runs < 0:
        return None
    return codes2, runs[: 2 * n_runs].reshape(-1, 2).astype(np.int64)


def _upload(genomes, codes2: np.ndarray, runs: np.ndarray, device: torch.device
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The host prep's arrays and the record starts after the first, on
    ``device``: (packed codes uint8, N runs int64 [n, 2], starts int64)."""
    starts = genomes.offsets[1: genomes.num_records]
    return (torch.from_numpy(codes2).to(device), torch.from_numpy(runs).to(device),
            torch.from_numpy(starts[starts < genomes.codes.size]).to(device))


def _valid_windows(g: int, k: int, packed: torch.Tensor, runs_d: torch.Tensor,
                   rec_starts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys int64, records int32) of the windows that hold no N and
    cross no record start, in genome order."""
    device = packed.device
    w = g - k + 1
    keys = encode_window(packed[None], k)[0][0, :w]

    one = torch.ones(runs_d.shape[0], dtype=torch.int32, device=device)
    delta = torch.zeros(g + 1, dtype=torch.int32, device=device)
    delta.index_add_(0, runs_d[:, 0], one).index_add_(0, runs_d[:, 1], -one)
    n_bad = torch.zeros(g + 1, dtype=torch.int32, device=device)  # N before i
    n_bad[1:] = torch.cumsum((torch.cumsum(delta[:g], 0) > 0).to(torch.int32), 0)
    ok = (n_bad[k:] - n_bad[:w]) == 0

    # record of each position: +1 at every record start after the first
    # (empty records add at the same position, so they are skipped)
    rec = torch.zeros(g, dtype=torch.int32, device=device)
    rec.index_add_(0, rec_starts, torch.ones_like(rec_starts, dtype=torch.int32))
    rec = torch.cumsum(rec, 0, dtype=torch.int32)
    ok &= rec[:w] == rec[k - 1:]
    return keys[ok], rec[:w][ok]


def _compute(g: int, r: int, k: int, packed: torch.Tensor, runs_d: torch.Tensor,
             rec_starts: torch.Tensor) -> Optional[dict]:
    """Steps 2-5 of the module doc on the device: the table (``keys``,
    ``sid``, ``gc``), the multi sets' packed (set, record) pairs ``pk``
    (set * R_CAP + record) and their count ``n_multi``; None past SMAX,
    PMAX or on a hash collision.  The counts the checks need are read on
    the way (each waits for the device)."""
    keys_v, rec_v = _valid_windows(g, k, packed, runs_d, rec_starts)
    device = packed.device
    sk, order = torch.sort(keys_v, stable=True)
    rec = rec_v[order].to(_I64)
    n = sk.numel()
    first = torch.ones(n, dtype=torch.bool, device=device)
    first[1:] = sk[1:] != sk[:-1]
    starts = first.nonzero().squeeze(1)
    u = starts.numel()
    ends = torch.empty_like(starts)
    ends[:-1] = starts[1:] - 1
    ends[-1:] = n - 1
    new_pair = first.clone()
    new_pair[1:] |= rec[1:] != rec[:-1]

    def group_sum(v: torch.Tensor) -> torch.Tensor:
        cs = torch.cumsum(v, 0)
        return cs[ends] - cs[starts] + v[starts]

    gc = group_sum(new_pair.to(_I64))
    sid = rec[starts].clone()
    multi = gc > 1
    pk = torch.zeros(0, dtype=_I64, device=device)
    n_multi = 0
    if bool(multi.any()):
        group = torch.cumsum(first.to(_I64), 0) - 1
        md = new_pair & multi[group]
        zero = torch.zeros((), dtype=_I64, device=device)
        h1 = group_sum(torch.where(md, _mix32((rec + 0x9E3779B9) & M32), zero)) & M32
        h2 = group_sum(torch.where(md, _mix32(rec ^ 0x85EBCA6B), zero)) & M32
        # gc mixed in, so sets of different sizes never share a hash
        gcm = _mix32((gc + 0xC2B2AE35) & M32)
        h1, h2 = h1 ^ gcm, (h2 + gcm) & M32
        mg = multi.nonzero().squeeze(1)
        # (h1 - 2**31) << 32 | h2 packs the pair into an int64 one to one
        uniq, midx = torch.unique((h1[mg] - (1 << 31)) * (1 << 32) + h2[mg],
                                  return_inverse=True)
        n_multi = uniq.numel()
        if n_multi > SMAX:
            return None
        set_of_group = torch.full((u,), -1, dtype=_I64, device=device)
        set_of_group[mg] = midx
        pk = torch.unique(set_of_group[group[md]] * R_CAP + rec[md])
        if pk.numel() > PMAX:
            return None
        # exact collision check: a multi group's genome count is the
        # distinct record count of its set, which merged sets exceed
        size = torch.bincount(pk // R_CAP, minlength=n_multi)
        if not bool((size[midx] == gc[mg]).all()):
            return None
        sid[mg] = r + midx
    return dict(keys=sk[starts], sid=sid.to(torch.int32), gc=gc.to(torch.int32),
                pk=pk, n_multi=n_multi)


def _fetch(computed: dict, r: int) -> dict:
    """The multi sets' pairs to the host, and the set masks made there:
    ``computed`` without ``pk``, with ``num_kmers``, ``num_sets`` and
    ``set_masks`` (module doc of ``device_build_tables``)."""
    out = {name: v for name, v in computed.items() if name not in ("pk", "n_multi")}
    pairs = computed["pk"].cpu().numpy()
    num_sets = r + computed["n_multi"]
    set_masks = np.zeros((num_sets, max((r + 7) // 8, 1)), dtype=np.uint8)
    rr = np.arange(r)
    set_masks[rr, rr >> 3] = np.uint8(1) << (rr & 7).astype(np.uint8)
    if pairs.size:
        sidx, recx = pairs // R_CAP, pairs % R_CAP
        np.bitwise_or.at(set_masks, (r + sidx, recx >> 3),
                         np.uint8(1) << (recx & 7).astype(np.uint8))
    return dict(out, num_kmers=out["keys"].numel(), num_sets=num_sets,
                set_masks=set_masks)


def device_build_tables(genomes, k: int, device: torch.device) -> Optional[dict]:
    """Build the sorted table and the set masks of ``genomes``
    (``io.packing.GenomeArrays``) on ``device``, in four steps:
    ``_host_prep``, ``_upload``, ``_compute`` and ``_fetch``.

    Returns a dict with tensors on ``device`` ``keys`` (int64 [U],
    ascending, distinct), ``sid`` and ``gc`` (int32 [U]); host
    ``set_masks`` (uint8 [num_sets, ceil(R/8)]: rows [0, R) the singleton
    sets {r}, rows [R, num_sets) the multi sets); ints ``num_kmers``,
    ``num_sets``, ``num_records``, ``num_windows`` (g - k + 1); and
    ``prep_s``, the host packing time.
    None when the build does not take the input (see the module doc)."""
    r = genomes.num_records
    g = int(genomes.codes.size)
    if k > 31 or r > R_CAP or g < k:
        return None
    t0 = time.perf_counter()
    with phase("db_host_prep"):
        prep = _host_prep(genomes)
    if prep is None:
        return None
    prep_s = time.perf_counter() - t0
    computed = _compute(g, r, k, *_upload(genomes, *prep, device))
    if computed is None:
        return None
    return dict(_fetch(computed, r), num_records=r, num_windows=g - k + 1,
                prep_s=prep_s)


class _Rows(NamedTuple):
    """Key-sorted rows to place, read on the device a chunk at a time:
    ``keys(a, b)`` int64 [b - a] (``hi << 32 | lo``) and ``payload(a, b)``
    (set ids, genome counts), int32 [b - a] each."""

    n: int
    keys: Callable[[int, int], torch.Tensor]
    payload: Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]


def _chunks(n: int):
    for a in range(0, n, _CHUNK):
        yield a, min(a + _CHUNK, n)


def _place(rows: _Rows, nb: int, slots: int, device: torch.device
           ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(table int32 [nb, slots, 4], stash int32 [<= STASH_CAP, 4]) of
    ``rows`` in the ``index/hashtable.py`` layout (uint32 bits as int32),
    or None when more than ``STASH_CAP`` rows overflow their bucket.

    A row's slot is its rank among its bucket's rows in key order, which
    is what the host builder's stable argsort gives, so the same rows give
    the same table and stash bit for bit.  Three passes, each over chunks
    of ``_CHUNK`` rows:
      1. each row's bucket (int32);
      2. one stable sort of the buckets; each row's rank in its bucket
         (sorted position less the bucket's first, by ``searchsorted``),
         clipped at ``slots`` into uint8 and scattered back to row order;
         the rows past their bucket's slots are counted;
      3. the table (filled only now: the sort's buffers are gone), each
         row written to its slot; the overflowing rows form the stash in
         (bucket, row) order, as the host builder's."""
    u = rows.n
    bucket = torch.empty(u, dtype=torch.int32, device=device)
    for a, b in _chunks(u):
        lo, hi = split_key(rows.keys(a, b))
        bucket[a:b] = mix32(lo, hi) & (nb - 1)
    bs, order = torch.sort(bucket, stable=True)
    rank = torch.empty(u, dtype=torch.uint8, device=device)
    over = torch.zeros((), dtype=_I64, device=device)
    for a, b in _chunks(u):
        r = (torch.arange(a, b, dtype=torch.int32, device=device)
             - torch.searchsorted(bs, bs[a:b], out_int32=True))
        over += (r >= slots).sum()
        rank[order[a:b]] = r.clamp_(max=slots).to(torch.uint8)
    del bs, order
    n_over = int(over)
    if n_over > STASH_CAP:
        return None
    table = torch.zeros((nb * slots, 4), dtype=torch.int32, device=device)
    table[:, 2] = -1  # EMPTY
    spill_b, spill_rows = [], []
    for a, b in _chunks(u):
        sid, gc = rows.payload(a, b)
        row = torch.cat([rows.keys(a, b).view(torch.int32).view(-1, 2),
                         sid[:, None], gc[:, None]], dim=1)
        r = rank[a:b]
        pos = bucket[a:b].to(_I64) * slots + r
        if n_over:
            keep = r < slots
            spill_b.append(bucket[a:b][~keep])
            spill_rows.append(row[~keep])
            pos, row = pos[keep], row[keep]
        table[pos] = row
    stash = torch.zeros((0, 4), dtype=torch.int32, device=device)
    if n_over:
        _, by_bucket = torch.sort(torch.cat(spill_b), stable=True)
        stash = torch.cat(spill_rows)[by_bucket]
    return table.view(nb, slots, 4), stash


def _budget(device: torch.device) -> int:
    """``$SHOTGUN_TPU_HASH_HBM_BUDGET`` in bytes, unset ``device``'s
    (``routes.device_routes``: the card's on CUDA, else
    ``HBM_BUDGET_DEFAULT``); a value that is not an integer raises, as in
    the JAX package."""
    budget = os.environ.get(HBM_BUDGET_ENV)
    return device_routes(device).hash_budget if budget is None else int(budget)


def device_hash_table(built: dict
                      ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(table int32 [nb, 16, 4], stash int32 [<= 64, 4]) on the build's
    device from ``device_build_tables`` output, or None when the table
    would pass the device's budget (``_budget``: 10 GB off a card) or the
    probe's slot limit (``index.hashtable.slots_fit``), or its stash still
    overflows after two doublings.  Both are
    deterministic; a device error raises, and so does a budget that is
    not an integer, as in the JAX package.

    The workspace term counts one row per genome window, as the JAX
    check counts its table's rows (one per window, rounded up to its
    shape bucket), not one per distinct key."""
    keys, sid, gc = built["keys"], built["sid"], built["gc"]
    rows = _Rows(built["num_kmers"], lambda a, b: keys[a:b],
                 lambda a, b: (sid[a:b], gc[a:b]))
    nb = _first_buckets(rows.n, HASH_SLOTS)
    budget = _budget(keys.device)
    for _ in range(3):
        # re-checked on every doubling: table + the build's workspace, and
        # the probe's slot limit
        if (nb * HASH_SLOTS * 16 + 8 * built["num_windows"] * 4 > budget
                or not slots_fit(nb, HASH_SLOTS)):
            return None
        placed = _place(rows, nb, HASH_SLOTS, keys.device)
        if placed is not None:
            return placed
        nb *= 2
    return None


def index_table_bytes(num_kmers: int, num_sets: int, slots: int, nb: int) -> int:
    """The device bytes ``index_hash_table`` holds at its peak for a table
    of ``nb`` buckets, counted from ``_place``: pass 3's table (16 B a
    slot) beside the buckets and ranks (5 B a row), the set sizes (4 B a
    set) and one chunk's temporaries, at most ``_CHUNK_ROW_BYTES`` a row:
    the chunk's upload (8 B of keys and 4 of set ids), its genome counts
    (4 B) and at most 112 B of int64 words, masks, positions and int32 rows
    in flight.  Pass 2 holds less: its sort, 36 B a row (the buckets,
    ``torch.sort``'s values and indices, its int64 iota and CUB's double
    buffers of both), stays below the table, which the host builder's
    sizing makes at least 64 B a row (16 slots a bucket, at most 4 keys a
    bucket; 4 slots, at most 1/4).  The index's columns stay on the
    host."""
    return nb * slots * 16 + 5 * num_kmers + 4 * num_sets + _CHUNK * _CHUNK_ROW_BYTES


def index_table_admitted(index, slots: int, device: torch.device) -> bool:
    """Whether ``device``'s budget (``_budget``) admits the table of
    ``index`` at the host builder's first bucket count."""
    u = index.num_kmers
    term = index_table_bytes(u, index.num_sets, slots, _first_buckets(u, slots))
    return term <= _budget(device)


def index_hash_table(index, slots: int, device: torch.device
                     ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(table int32 [nb, slots, 4], stash int32 [<= 64, 4]) on ``device``
    of a host ``KmerIndex`` at k <= 31 (built, loaded from a ``.kdb`` or
    EXTSIM-filtered), bit for bit the tables of ``build_probe_table(...,
    slots_per_bucket=slots)`` for ``slots`` in {4, 16}: the same first
    bucket count, doubled while more than ``STASH_CAP`` rows overflow, and
    every row placed, genome count 0 included.

    Uploaded a chunk at a time: the index's own key column
    (``ops.probe_sort.host_key_words``: an int64 view of ``kmer_words``,
    no host pass), its set ids, and its set sizes once, from which the
    genome counts are gathered on the device.  Keys go up twice (for the
    buckets, then for the rows), so nothing of the index stays on the
    device.

    None when ``index_table_bytes`` passes ``device``'s budget
    (``_budget``: 10 GB off a card), checked at the first bucket count and
    on every doubling; the caller then builds the table on the host.
    ``SlotLimitError`` when the table would pass the probe's slot limit, as
    the host builder raises.  A device error raises."""
    keys = host_key_words(index.kmer_words, index.k)[0]
    sid = np.ascontiguousarray(index.set_id, dtype=np.int32)
    sizes = torch.from_numpy(np.ascontiguousarray(index.set_sizes, dtype=np.int32)).to(device)

    def payload(a: int, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
        s = torch.from_numpy(sid[a:b]).to(device)
        return s, sizes.index_select(0, s)

    rows = _Rows(index.num_kmers, lambda a, b: torch.from_numpy(keys[a:b]).to(device),
                 payload)
    nb = _first_buckets(rows.n, slots)
    budget = _budget(device)
    while index_table_bytes(rows.n, index.num_sets, slots, nb) <= budget:
        check_slot_limit(nb, slots)
        placed = _place(rows, nb, slots, device)
        if placed is not None:
            return placed
        nb *= 2
    return None
