"""Batched pseudo-alignment on the device (counterpart of
``shotgun_tpu/models/pipeline.py``, k <= 31).

Per batch of 2-bit packed reads, all on the device:

  1. unpack + rolling k-mer encode (+ MKQ window sums)  kernel H1
  2. probe, by the table's type: the bucket hash (kernel H2) or the sort
     join (``ops/probe_sort2.py``, which also does step 5)
  3. integer quality gates: MRQ read gate, MKQ window gate
  4. max-genomes gate
  5. first-occurrence dedupe of k-mer values within a read
  6. per-record specific/total distinct-k-mer counts + first-window keys
  7. the m/p decision with the reference's tie-breaking and downgrade
     quirks
  8. per-batch aggregation into per-record counters and first-encounter
     order keys, folded into a device-resident carry (fetched once a run)
  9. for the align task's read store: each read's mapping list
     (``store_lists``), compacted on the device and fetched per batch

Every count is an integer: the JAX package counts through a float32
``jnp.dot`` (its ``pipeline.py:195-206``); here the set-member rows of
each window are gathered and summed in int32, so no matrix unit (and no
TF32) ever touches a count.  The TPU workarounds of the JAX module (the
zero-anchor, lengths packed into the codes, the superbatch scan, the
``optimization_barrier`` fences) have no counterpart.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from shotgun_tpu_torch.ops.encode import encode_window, window_quality_sums
from shotgun_tpu_torch.ops.probe import HashTableDev, probe_kmers
from shotgun_tpu_torch.ops.probe_sort import SortedTableDev
from shotgun_tpu_torch.ops.probe_sort2 import probe_dedupe_sorted

BIG = 0x3FFFFFFF
FOLD_INF = 0x7FFFFFFF

# ReadMappingType codes (device-side)
UNMAPPED, UNIQUELY_MAPPED, AMBIGUOUSLY_MAPPED = 0, 1, 2

#: elements of one [B, window chunk, R] membership tile in the count block
COUNT_TILE = 1 << 26

_I32 = torch.int32


class BatchResult(NamedTuple):
    """Per-read device outputs for one batch."""

    mtype: torch.Tensor          # int32 [B] 0/1/2
    winner: torch.Tensor         # int32 [B] record id (unique/downgraded rows)
    downgraded: torch.Tensor     # bool  [B]
    amb_mask: torch.Tensor       # bool  [B, R] members of the ambiguous list
    fw_sel: torch.Tensor         # int32 [B, R] first-window order key
    read_filtered: torch.Tensor  # bool  [B] MRQ-filtered (not added at all)
    n_qual_kmers: torch.Tensor   # int32 [B] per-occurrence MKQ filter count
    n_hr_kmers: torch.Tensor     # int32 [B] per-occurrence max-genomes count


def _first_occurrence(slot_pos: torch.Tensor, stored: torch.Tensor) -> torch.Tensor:
    """[B, W] mask of stored windows whose slot_pos no earlier stored
    window of the row has.

    Replaces the JAX form's [B, W, W] pairwise mask (550 MB at B = 32768,
    W = 130): a stable per-row sort groups equal slot positions in window
    order, and the head of each group is the first occurrence."""
    vals = torch.where(stored, slot_pos.to(torch.int64),
                       torch.iinfo(torch.int64).max)
    sv, order = torch.sort(vals, dim=1, stable=True)
    head = torch.ones_like(stored)
    head[:, 1:] = sv[:, 1:] != sv[:, :-1]
    return torch.zeros_like(stored).scatter_(1, order, head) & stored


def _record_counts(sid, spec_w, first_occ, member):
    """Per-record distinct-k-mer counts and first windows, in integers.

    spec_counts/total_counts [B, R]: specific / all first-occurrence
    windows whose set holds the record; fw_spec/fw_total: the first such
    window, BIG if none.  The [B, W, R] evidence is gathered from the set
    rows one window chunk at a time so memory stays at COUNT_TILE."""
    b, w = sid.shape
    r = member.shape[1]
    dev = sid.device
    sid_c = sid.clamp(min=0).to(torch.int64)
    w_iota = torch.arange(w, device=dev, dtype=_I32)
    spec_counts = torch.zeros((b, r), dtype=_I32, device=dev)
    total_counts = torch.zeros((b, r), dtype=_I32, device=dev)
    fw_spec = torch.full((b, r), BIG, dtype=_I32, device=dev)
    fw_total = torch.full((b, r), BIG, dtype=_I32, device=dev)
    wc = max(1, min(w, COUNT_TILE // max(b * r, 1)))
    for w0 in range(0, w, wc):
        sl = slice(w0, w0 + wc)
        mem = member[sid_c[:, sl]]                       # bool [B, wc, R]
        sp = mem & spec_w[:, sl, None]
        to = mem & first_occ[:, sl, None]
        spec_counts += sp.sum(dim=1, dtype=_I32)
        total_counts += to.sum(dim=1, dtype=_I32)
        wi = w_iota[sl][None, :, None]
        fw_spec = torch.minimum(fw_spec, torch.where(sp, wi, BIG).amin(dim=1))
        fw_total = torch.minimum(fw_total, torch.where(to, wi, BIG).amin(dim=1))
    return spec_counts, total_counts, fw_spec, fw_total


def core_from_probe(
    probe_res: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    set_member: torch.Tensor,       # bool/uint8 [S, R]
    qual: Optional[torch.Tensor],   # uint8 [B, L]; None without quality gates
    lengths: torch.Tensor,          # int32 [B]
    m: int, p: int, mrq: int, mkq: int, mg: int,
    *,
    k: int,
    has_mrq: bool,
    has_mkq: bool,
    has_mg: bool,
    qsum: Optional[torch.Tensor] = None,
    pre_first_occ: Optional[torch.Tensor] = None,
) -> BatchResult:
    """Everything after the probe: gates, dedupe, counts, m/p decision.

    ``qsum``: the [B, W] window quality sums when already computed (kernel
    H1 makes them with the keys); otherwise they come from ``qual``.
    ``pre_first_occ``: the within-read first-occurrence mask when the probe
    made it (the sort join); ``probe_res``'s slot_pos is then unused.  The
    max-genomes gate masks whole keys, so masking it by ``stored`` is
    exact."""
    hit, sid, gcount, slot_pos = probe_res
    b, w = hit.shape
    dev = hit.device
    member = set_member if set_member.dtype == torch.bool else set_member != 0
    r = member.shape[1]
    w_iota = torch.arange(w, device=dev, dtype=_I32)[None, :]
    r_iota = torch.arange(r, device=dev, dtype=_I32)[None, :]

    lens = lengths.to(_I32)
    valid = w_iota < (lens - (k - 1))[:, None]

    # ---- quality gates (exact integer forms of raw-ord means) ----
    if has_mrq:
        total_q = qual.to(torch.int64).sum(dim=1)  # pads are 0
        read_filtered = total_q < mrq * lens.to(torch.int64)
    else:
        read_filtered = torch.zeros((b,), dtype=torch.bool, device=dev)
    if has_mkq:
        if qsum is None:
            qsum = window_quality_sums(qual, k)
        kq_fail = valid & (qsum < mkq * k)
        kq_ok = valid & ~kq_fail
        n_qual_kmers = kq_fail.sum(dim=1, dtype=_I32)
    else:
        kq_ok = valid
        n_qual_kmers = torch.zeros((b,), dtype=_I32, device=dev)

    # ---- max-genomes gate ----
    hit = hit & kq_ok
    if has_mg:
        redundant = hit & (gcount > mg)
        n_hr_kmers = redundant.sum(dim=1, dtype=_I32)
        stored = hit & ~redundant
    else:
        n_hr_kmers = torch.zeros((b,), dtype=_I32, device=dev)
        stored = hit

    # ---- first-occurrence dedupe, per-record counts ----
    if pre_first_occ is not None:
        first_occ = pre_first_occ & stored
    else:
        first_occ = _first_occurrence(slot_pos, stored)
    spec_w = first_occ & (gcount == 1)
    spec_counts, total_counts, fw_spec, fw_total = _record_counts(
        sid, spec_w, first_occ, member)

    # ---- m-decision over specific counts ----
    has_kmers = first_occ.any(dim=1)
    n_spec = (spec_counts > 0).sum(dim=1, dtype=_I32)
    maxc = spec_counts.amax(dim=1)
    tie_key = torch.where(
        (spec_counts == maxc[:, None]) & (spec_counts > 0), fw_spec, BIG)
    winner = tie_key.argmin(dim=1).to(_I32)  # first minimum, as jnp.argmin
    winner_oh = r_iota == winner[:, None]
    second_val = torch.where(winner_oh, -1, spec_counts).amax(dim=1)
    unique_spec = (n_spec == 1) | ((n_spec > 1) & (maxc >= second_val + m))

    # ---- p-validation / downgrade ----
    mt = torch.where(winner_oh, total_counts, 0).sum(dim=1, dtype=_I32)
    max_total = total_counts.amax(dim=1)
    if p >= 0:
        downgraded = unique_spec & ((max_total - mt) > p)
    else:
        downgraded = torch.zeros_like(unique_spec)

    is_unique = unique_spec & ~downgraded
    mtype = torch.where(
        ~has_kmers, UNMAPPED,
        torch.where(is_unique, UNIQUELY_MAPPED, AMBIGUOUSLY_MAPPED)).to(_I32)
    is_amb = mtype == AMBIGUOUSLY_MAPPED
    amb_mask = torch.where(
        downgraded[:, None], total_counts >= mt[:, None], spec_counts > 0
    ) & is_amb[:, None]
    fw_sel = torch.where(downgraded[:, None], fw_total, fw_spec)

    return BatchResult(
        mtype=mtype,
        winner=winner,
        downgraded=downgraded & is_amb,
        amb_mask=amb_mask,
        fw_sel=fw_sel,
        read_filtered=read_filtered,
        n_qual_kmers=n_qual_kmers,
        n_hr_kmers=n_hr_kmers,
    )


def _window_ok(qual, lengths, k: int, w: int, mkq: int, has_mkq: bool,
               qsum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, W] mask of windows inside the read that pass the MKQ gate."""
    w_iota = torch.arange(w, device=lengths.device, dtype=_I32)[None, :]
    valid = w_iota < (lengths.to(_I32) - (k - 1))[:, None]
    if has_mkq:
        if qsum is None:
            qsum = window_quality_sums(qual, k)
        return valid & (qsum >= mkq * k)
    return valid


class AggResult(NamedTuple):
    """Per-batch counters, merged exactly across batches (int32)."""

    n_unique: torch.Tensor        # int32 []
    n_ambiguous: torch.Tensor     # int32 []
    n_unmapped: torch.Tensor      # int32 []
    n_filtered_reads: torch.Tensor
    n_filtered_kmers: torch.Tensor
    n_hr_kmers: torch.Tensor
    unique_by_rec: torch.Tensor   # int32 [R]
    amb_by_rec: torch.Tensor      # int32 [R]
    first_key: torch.Tensor       # int32 [R] min of row*(R+2)+pos, BIG if absent


class FoldCarry(NamedTuple):
    """Device-resident accumulation of AggResults across batches; the
    caller fetches it once a run.  int32 throughout, as in the JAX
    package (its host totals stay int64 across calls)."""

    counters: torch.Tensor       # int32 [6]: uniq, amb, unmapped, f_reads, f_kmers, hr
    unique_by_rec: torch.Tensor  # int32 [R]
    amb_by_rec: torch.Tensor     # int32 [R]
    first_batch: torch.Tensor    # int32 [R], FOLD_INF when unseen
    first_key: torch.Tensor      # int32 [R]
    batch_no: torch.Tensor       # int32 [] index of the NEXT batch to fold


def init_fold_carry(r: int, device: torch.device, start_batch: int = 0) -> FoldCarry:
    def full(n, v):
        return torch.full((n,), v, dtype=_I32, device=device)

    return FoldCarry(
        counters=full(6, 0),
        unique_by_rec=full(r, 0),
        amb_by_rec=full(r, 0),
        first_batch=full(r, FOLD_INF),
        first_key=full(r, FOLD_INF),
        batch_no=torch.tensor(start_batch, dtype=_I32, device=device),
    )


def _fold_agg(carry: FoldCarry, agg: AggResult) -> FoldCarry:
    """Fold one batch's AggResult into the running carry; the batch index
    lives in the carry, so nothing per batch comes from the host."""
    counters = carry.counters + torch.stack([
        agg.n_unique, agg.n_ambiguous, agg.n_unmapped,
        agg.n_filtered_reads, agg.n_filtered_kmers, agg.n_hr_kmers,
    ]).to(_I32)
    fresh = (agg.first_key < BIG) & (carry.first_batch == FOLD_INF)
    return FoldCarry(
        counters=counters,
        unique_by_rec=carry.unique_by_rec + agg.unique_by_rec,
        amb_by_rec=carry.amb_by_rec + agg.amb_by_rec,
        first_batch=torch.where(fresh, carry.batch_no, carry.first_batch),
        first_key=torch.where(fresh, agg.first_key, carry.first_key),
        batch_no=carry.batch_no + 1,
    )


def aggregate_batch(res: BatchResult, row_valid: torch.Tensor) -> AggResult:
    """Fold per-read outputs into per-record counters + order keys.

    ``first_key`` reconstructs the reference's Summary dict insertion
    order: per read, genomes are met in list order; across reads, in
    input order.  The position in the list is the rank of the
    (first-window, record) key; a downgrade's prepended winner gets 0."""
    b, r = res.amb_mask.shape
    dev = res.amb_mask.device
    r_iota = torch.arange(r, device=dev, dtype=torch.int64)[None, :]
    row_iota = torch.arange(b, device=dev, dtype=torch.int64)[:, None]

    live = row_valid & ~res.read_filtered
    is_u = live & (res.mtype == UNIQUELY_MAPPED)
    is_a = live & (res.mtype == AMBIGUOUSLY_MAPPED)
    is_n = live & (res.mtype == UNMAPPED)

    winner_onehot = r_iota == res.winner[:, None]
    unique_by_rec = (winner_onehot & is_u[:, None]).sum(dim=0, dtype=_I32)
    dg_winner = (res.downgraded & is_a)[:, None] & winner_onehot
    amb_inc = res.amb_mask.to(_I32) + dg_winner.to(_I32)
    amb_by_rec = torch.where(is_a[:, None], amb_inc, 0).sum(dim=0, dtype=_I32)

    # in-list membership + position; keys in int64, so fw_sel * r cannot
    # wrap on entries that are masked afterwards
    in_list = torch.where(is_u[:, None], winner_onehot,
                          res.amb_mask & is_a[:, None])
    key = res.fw_sel.to(torch.int64) * r + r_iota  # lexicographic (fw, record)
    key = torch.where(dg_winner, -1, key)
    key = torch.where(in_list, key, BIG)
    # rank of each in-list key within its row.  In-list keys are distinct
    # and below BIG, so their sorted position equals the count of smaller
    # keys: the JAX package's pairwise count (R <= 512) and its
    # argsort-of-argsort (R > 512) agree on them, and one form serves
    # every R here without the [B, R, R] intermediate.
    order = torch.argsort(key, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    enc_key = torch.where(in_list, row_iota * (r + 2) + rank, BIG)
    first_key = enc_key.amin(dim=0).to(_I32)

    def total(x):
        return x.sum(dtype=_I32)

    return AggResult(
        n_unique=total(is_u),
        n_ambiguous=total(is_a),
        n_unmapped=total(is_n),
        n_filtered_reads=total(row_valid & res.read_filtered),
        n_filtered_kmers=total(torch.where(live, res.n_qual_kmers, 0)),
        n_hr_kmers=total(torch.where(live, res.n_hr_kmers, 0)),
        unique_by_rec=unique_by_rec,
        amb_by_rec=amb_by_rec,
        first_key=first_key,
    )


class StoreLists(NamedTuple):
    """One batch's per-read outputs as the read store keeps them (the
    reference's per-read mapping type and genomes_mapped_to list,
    kmer.py:536-549)."""

    word: torch.Tensor    # int8  [B] mtype | read_filtered << 2
    counts: torch.Tensor  # int32 [B] list length, 0 for MRQ-filtered rows
    flat: torch.Tensor    # int64 [sum(counts)] record ids, row after row


def store_lists(res: BatchResult, rows: int) -> StoreLists:
    """The mapping list of each of the first ``rows`` reads, on the device.

    A read's list is the winner for a unique read and the ambiguous
    members otherwise, ordered by (first window, record), with a
    downgraded winner first (the order of the JAX package's
    ``_store_packed_reads``, its ``aligner.py:991-1017``).  Only the
    in-list entries are sorted: they are compacted (``nonzero``, which
    waits for the batch) and put in order by two stable sorts, by key and
    then by row, so nothing here is [B, R] beyond the mask.  Replaces the
    JAX form, which keeps a [B, R] key block of every batch on the device
    and sorts the whole block on the host after the run."""
    res = BatchResult(*(x[:rows] for x in res))
    r = res.amb_mask.shape[1]
    is_u = res.mtype == UNIQUELY_MAPPED
    is_a = res.mtype == AMBIGUOUSLY_MAPPED
    r_iota = torch.arange(r, device=res.mtype.device, dtype=torch.int64)[None, :]
    winner_onehot = r_iota == res.winner[:, None]
    in_list = torch.where(is_u[:, None], winner_onehot,
                          res.amb_mask & is_a[:, None])
    in_list &= ~res.read_filtered[:, None]
    row, rec = in_list.nonzero(as_tuple=True)
    key = res.fw_sel[row, rec].to(torch.int64) * r + rec
    key = torch.where(res.downgraded[row] & (rec == res.winner[row]), -1, key)
    by_key = torch.argsort(key, stable=True)
    order = by_key[torch.argsort(row[by_key], stable=True)]
    word = res.mtype | (res.read_filtered.to(_I32) << 2)
    return StoreLists(word=word.to(torch.int8),
                      counts=in_list.sum(dim=1, dtype=_I32),
                      flat=rec[order])


def store_lists_plain(word: np.ndarray, keys: np.ndarray, r: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy reference for ``store_lists``, from the JAX package's packed
    store words (its ``pack_store_words``: word = mtype | downgraded << 2 |
    read_filtered << 3 | winner << 4, keys [B, R'] int16 or int32), as its
    ``_store_packed_reads`` unpacks them (``aligner.py:991-1017``):
    (word as ``store_lists`` packs it, counts, flat)."""
    rows = word.size
    mtype = word & 3
    downgraded = ((word >> 2) & 1).astype(bool)
    filtered = ((word >> 3) & 1).astype(bool)
    winner = word >> 4
    sent = (int(np.iinfo(np.int16).max) if keys.dtype == np.int16
            else BIG)
    in_list = keys[:, :r] < sent
    r_iota = np.arange(r, dtype=np.int64)[None, :]
    inf = np.iinfo(np.int64).max
    key = np.where(in_list, keys[:, :r].astype(np.int64) * r + r_iota, inf)
    ar = np.arange(rows)
    key[ar, winner] = np.where(downgraded, -1, key[ar, winner])
    order = np.argsort(key, axis=1, kind="stable")
    in_sorted = np.take_along_axis(in_list, order, axis=1)
    in_sorted &= ~filtered[:, None]
    counts = in_sorted.sum(axis=1)
    return ((mtype | filtered.astype(mtype.dtype) << 2).astype(np.int8),
            counts.astype(np.int32), order[in_sorted])


#: the probe tables ``align_batch`` dispatches on
DeviceTable = Union[HashTableDev, SortedTableDev]


def align_batch(
    probe_tab: DeviceTable,
    set_member: torch.Tensor,        # bool [S, R]
    codes: torch.Tensor,             # uint8 [B, L/4] 2-bit packed
    qual: Optional[torch.Tensor],    # uint8 [B, L] when a quality gate is on
    lengths: torch.Tensor,           # int32 [B]
    m: int, p: int, mrq: int, mkq: int, mg: int,
    *,
    k: int,
    has_mrq: bool,
    has_mkq: bool,
    has_mg: bool,
) -> BatchResult:
    """Encode + probe + classify one batch, the probe chosen by the
    table's type (the JAX package's ``align_batch_core``)."""
    keys, qsum = encode_window(codes, k, qual if has_mkq else None)
    first_occ = None
    if isinstance(probe_tab, SortedTableDev):
        query_ok = _window_ok(None, lengths, k, keys.shape[1], mkq, has_mkq,
                              qsum=qsum)
        hit, sid, gc, first_occ = probe_dedupe_sorted(probe_tab, keys, query_ok)
        probe_res = (hit, sid, gc, None)
    else:
        probe_res = probe_kmers(probe_tab.table, probe_tab.stash, keys)
    return core_from_probe(
        probe_res, set_member, qual, lengths, m, p, mrq, mkq, mg,
        k=k, has_mrq=has_mrq, has_mkq=has_mkq, has_mg=has_mg, qsum=qsum,
        pre_first_occ=first_occ)


def align_fold_batch(
    carry: FoldCarry,
    probe_tab: DeviceTable,
    set_member: torch.Tensor,
    codes: torch.Tensor,
    qual: Optional[torch.Tensor],
    lengths: torch.Tensor,           # int32 [B]; 0 marks tail padding rows
    m: int, p: int, mrq: int, mkq: int, mg: int,
    *,
    k: int,
    has_mrq: bool,
    has_mkq: bool,
    has_mg: bool,
) -> FoldCarry:
    """One streamed batch: ``align_batch`` + aggregate + fold.

    Zero-length rows are the tail padding of the final chunk (the FASTQ
    grammar requires a nonempty sequence line), so ``row_valid`` is
    ``lengths > 0``."""
    res = align_batch(probe_tab, set_member, codes, qual, lengths,
                      m, p, mrq, mkq, mg, k=k, has_mrq=has_mrq,
                      has_mkq=has_mkq, has_mg=has_mg)
    return _fold_agg(carry, aggregate_batch(res, lengths > 0))
