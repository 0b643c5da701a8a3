"""K-mer database build on the device (counterpart of
``shotgun_tpu/index/device_build.py``).

Builds what ``dumpalign`` needs of the index -- the key-sorted table of
distinct k-mers with their genome-set ids and genome counts, and the
genome-set member masks -- on the device, and the 16-slot hash table the
bucket probe (kernel H2) reads.  Only the multi-record sets' (set,
record) pairs, at most ``PMAX``, come back to the host.

  1. host: 2-bit pack of the genome codes and the list of N runs
     (``shotgun_tpu.io.native.pack2``, numpy without the native library);
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
from typing import Optional, Tuple

import numpy as np
import torch

from shotgun_tpu.io import native as _native
from shotgun_tpu_torch.index.hashtable import STASH_CAP
from shotgun_tpu_torch.ops.encode import M32, encode_window, mix32, pack_codes_2bit, split_key

#: record-count cap: a (set, record) pair packs as set * R_CAP + record
R_CAP = 4096
#: cap on distinct multi-record genome sets
SMAX = 4096
#: cap on (multi set, record) pairs fetched to the host
PMAX = 1 << 17
#: N-run cap of the JAX build's upload (one of its slots holds its pad)
NRUNS_CAP = 1 << 16

#: 16-slot hash table sizing (the host builder's wide-bucket layout)
HASH_SLOTS = 16
HASH_LAMBDA = 4.0
HBM_BUDGET_ENV = "SHOTGUN_TPU_HASH_HBM_BUDGET"
HBM_BUDGET_DEFAULT = 10_000_000_000

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


def _valid_windows(genomes, k: int, codes2: np.ndarray, runs: np.ndarray,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys int64, records int32) of the windows that hold no N and
    cross no record start, in genome order."""
    g = int(genomes.codes.size)
    w = g - k + 1
    packed = torch.from_numpy(codes2).to(device)
    keys = encode_window(packed[None], k)[0][0, :w]

    runs_d = torch.from_numpy(runs).to(device)
    one = torch.ones(runs_d.shape[0], dtype=torch.int32, device=device)
    delta = torch.zeros(g + 1, dtype=torch.int32, device=device)
    delta.index_add_(0, runs_d[:, 0], one).index_add_(0, runs_d[:, 1], -one)
    n_bad = torch.zeros(g + 1, dtype=torch.int32, device=device)  # N before i
    n_bad[1:] = torch.cumsum((torch.cumsum(delta[:g], 0) > 0).to(torch.int32), 0)
    ok = (n_bad[k:] - n_bad[:w]) == 0

    # record of each position: +1 at every record start after the first
    # (empty records add at the same position, so they are skipped)
    starts = torch.from_numpy(genomes.offsets[1: genomes.num_records]).to(device)
    starts = starts[starts < g]
    rec = torch.zeros(g, dtype=torch.int32, device=device)
    rec.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    rec = torch.cumsum(rec, 0, dtype=torch.int32)
    ok &= rec[:w] == rec[k - 1:]
    return keys[ok], rec[:w][ok]


def device_build_tables(genomes, k: int, device: torch.device) -> Optional[dict]:
    """Build the sorted table and the set masks of ``genomes``
    (``io.packing.GenomeArrays``) on ``device``.

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
    prep = _host_prep(genomes)
    if prep is None:
        return None
    prep_s = time.perf_counter() - t0

    keys_v, rec_v = _valid_windows(genomes, k, *prep, device)
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
    pairs = np.zeros(0, dtype=np.int64)
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
        pairs = pk.cpu().numpy()

    num_sets = r + n_multi
    set_masks = np.zeros((num_sets, max((r + 7) // 8, 1)), dtype=np.uint8)
    rr = np.arange(r)
    set_masks[rr, rr >> 3] = np.uint8(1) << (rr & 7).astype(np.uint8)
    if pairs.size:
        sidx, recx = pairs // R_CAP, pairs % R_CAP
        np.bitwise_or.at(set_masks, (r + sidx, recx >> 3),
                         np.uint8(1) << (recx & 7).astype(np.uint8))
    return dict(keys=sk[starts], sid=sid.to(torch.int32), gc=gc.to(torch.int32),
                num_kmers=u, num_sets=num_sets, set_masks=set_masks,
                num_records=r, num_windows=g - k + 1, prep_s=prep_s)


def _i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensors of the same bits."""
    return (((x + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)


def _hash_table_from_rows(keys, sid, gc, nb: int):
    """The 16-slot bucket table (``index/hashtable.py`` layout, as int32
    bits) and its overflow stash from distinct key-sorted rows.

    A stable sort by bucket keeps key order inside each bucket, as the
    host builder's stable argsort does, so the same rows give the same
    table bit for bit."""
    u = keys.numel()
    dev = keys.device
    lo, hi = split_key(keys)
    bucket = mix32(lo, hi) & (nb - 1)
    bs, order = torch.sort(bucket, stable=True)
    new = torch.ones(u, dtype=torch.bool, device=dev)
    new[1:] = bs[1:] != bs[:-1]
    # rank in the bucket: position minus the bucket's first position (a
    # prefix count and a gather; torch.cummax on CUDA is 50-250x slower
    # than a prefix sum on one long row)
    first = new.nonzero().squeeze(1)
    rank = torch.arange(u, device=dev) - first[torch.cumsum(new, 0) - 1]
    rows = _i32_bits(torch.stack(
        [lo, hi, sid.to(_I64), gc.to(_I64)], dim=1)[order])
    placed = rank < HASH_SLOTS
    table = torch.zeros((nb * HASH_SLOTS, 4), dtype=torch.int32, device=dev)
    table[:, 2] = -1  # EMPTY
    table[(bs * HASH_SLOTS + rank)[placed]] = rows[placed]
    return table.view(nb, HASH_SLOTS, 4), rows[~placed]


def device_hash_table(built: dict
                      ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(table int32 [nb, 16, 4], stash int32 [<= 64, 4]) on the build's
    device from ``device_build_tables`` output, or None when the table
    would pass ``$SHOTGUN_TPU_HASH_HBM_BUDGET`` bytes (10 GB by default)
    or its stash still overflows after two doublings.  Both are
    deterministic; a device error raises, and so does a budget that is
    not an integer, as in the JAX package.

    The workspace term counts one row per genome window, as the JAX
    check counts its table's rows (one per window, rounded up to its
    shape bucket), not one per distinct key."""
    u = built["num_kmers"]
    nb = 1 << max(int(max(u / HASH_LAMBDA, 1)) - 1, 1).bit_length()
    budget = int(os.environ.get(HBM_BUDGET_ENV, HBM_BUDGET_DEFAULT))
    for _ in range(3):
        # re-checked on every doubling: table + the build's workspace
        if nb * HASH_SLOTS * 16 + 8 * built["num_windows"] * 4 > budget:
            return None
        table, stash = _hash_table_from_rows(
            built["keys"], built["sid"], built["gc"], nb)
        if stash.shape[0] <= STASH_CAP:
            return table, stash
        nb *= 2
    return None
