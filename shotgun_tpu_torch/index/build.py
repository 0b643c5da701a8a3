"""K-mer index construction: dense array replacement for the reference's
``kmers: Dict[str, Dict[Record, Set[int]]]`` (reference kmer.py:130-150);
the port's copy of ``shotgun_tpu/index/build.py``.

Layout
------
Distinct k-mers are 2-bit packed into ``nw = max(2, ceil(k/16))`` uint32
words (little-word order: column j holds bits [32j, 32j+32) of the packed
value) and identified by their rank in sorted key order ("kmer id").  Any
k is supported, matching the reference's plain-string keys (reference
kmer.py:84-94; its RUN_LOG demos k=75 and k=150).  For k <= 31 the two
words are exactly the historical (lo, hi) pair, so the uint64 fast paths
and the bucketized hash probe keep working unchanged.  Alongside:

* ``first_seen`` -- global scan index of each k-mer's first occurrence.
  This reconstructs the reference's dict-insertion order for dumpref
  (genome input order, then position order; reference kmer.py:141-150).
* CSR postings sorted by (kmer id, scan order): the per-k-mer
  {record -> positions} mapping, with record order inside a k-mer equal to
  genome input order -- exactly the reference's nested dict insertion order.
* Per-k-mer genome *bitmask sets*, deduplicated into a set table
  (``set_masks``/``set_sizes``): the probe path resolves a k-mer to a set id
  and gets specificity (|set| == 1) and the max-genomes gate from
  ``set_sizes`` in O(1).

K-mers containing N never enter the index (reference kmer.py:145).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from shotgun_tpu_torch import constants
from shotgun_tpu_torch.io.packing import GenomeArrays

_U32 = np.uint32
_U64 = np.uint64


def num_key_words(k: int) -> int:
    """uint32 words per packed k-mer key: max(2, ceil(k/16)).

    Minimum 2 keeps the k <= 31 layout identical to the historical
    (lo, hi) pair (word 1 is zero for k <= 16)."""
    return max(2, -(-int(k) // 16))


def _pow_packs(c32: np.ndarray, n: int, up_to: int):
    """Doubling ladder of 2-bit packs: packs[p][i] = pack of c32[i:i+p]
    (length n-p+1), for p in {1, 2, 4, 8, 16} up to ``up_to``.

    Stops once a doubled pack would not fit in the array (2p > n) --
    every span composed by ``_pack_span`` is <= k <= n, so its largest
    power-of-two piece is always still built."""
    packs = {1: c32}
    p = 1
    while p < up_to and 2 * p <= n:
        half = packs[p]
        p *= 2
        packs[p] = (half[: n - p + 1] << _U32(p)) | half[p // 2: n - p // 2 + 1]
    return packs


def _pack_span(packs, start: int, span: int, w: int) -> np.ndarray:
    """2-bit pack of ``span`` (1..16) bases at window offset ``start``,
    vectorized over w windows, composed from the doubling ladder in
    O(popcount(span)) passes instead of O(span)."""
    acc = None
    off = start
    for p in (16, 8, 4, 2, 1):
        if span & p:
            piece = packs[p][off: off + w]
            acc = piece if acc is None else (acc << _U32(2 * p)) | piece
            off += p
    return acc


def rolling_encode_words(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """All k-windows of a code array -> ([W, nw] uint32 key words, validity).

    Window i covers codes[i:i+k]; invalid when it contains an N.  Word j
    (little-word order) holds bases t in [k-16(j+1), k-16j) of the window,
    so every word is a contiguous 16-base (top word: k mod 16) pack,
    composed from a doubling ladder of power-of-two packs -- O(log k)
    shift passes over W-length arrays total, independent of k and of the
    word count.  Empty when k <= 0 or k > len(codes)
    (reference kmer.py:91-92).
    """
    n = codes.size
    nw = num_key_words(max(k, 1))
    if k <= 0 or k > n:
        return np.zeros((0, nw), dtype=_U32), np.zeros(0, dtype=bool)
    w = n - k + 1
    c32 = codes.astype(_U32) & _U32(3)
    packs = _pow_packs(c32, n, min(16, 1 << (k - 1).bit_length()))
    words = np.zeros((w, nw), dtype=_U32)
    for j in range(nw):
        t_hi = k - 16 * j
        if t_hi <= 0:
            break  # zero-padded word (k <= 16 with the 2-word minimum)
        t_lo = max(t_hi - 16, 0)
        words[:, j] = _pack_span(packs, t_lo, t_hi - t_lo, w)
    bad = (codes >= constants.BASE_N).astype(np.int32)
    cs = np.concatenate([np.zeros(1, dtype=np.int32), np.cumsum(bad, dtype=np.int32)])
    valid = (cs[k:] - cs[:-k]) == 0
    return words, valid


def rolling_encode(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Back-compat (lo, hi) form of ``rolling_encode_words`` -- k <= 31 only."""
    assert k <= 31, "rolling_encode is the 2-word fast form; use rolling_encode_words"
    words, valid = rolling_encode_words(codes, k)
    return words[:, 0].copy(), words[:, 1].copy(), valid


def pack_key64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return (hi.astype(_U64) << _U64(32)) | lo.astype(_U64)


_LITTLE = __import__("sys").byteorder == "little"


def sort_keys_from_words(words: np.ndarray) -> np.ndarray:
    """[N, nw] key words -> one sortable key per row.

    nw == 2: the packed uint64 (fast path; on little-endian machines a
    C-contiguous (lo, hi) row IS the uint64 in memory, so it's a view).
    Wider: big-endian fixed-width byte strings, whose bytewise (numpy 'S')
    order equals numeric order -- argsort/searchsorted/!= all work on
    them directly."""
    if words.shape[1] <= 2:
        if _LITTLE and words.flags.c_contiguous and words.shape[1] == 2:
            return words.view(_U64).reshape(-1)
        return pack_key64(words[:, 0], words[:, 1])
    be = np.ascontiguousarray(words[:, ::-1].astype(">u4"))
    return be.view(f"S{4 * words.shape[1]}").reshape(-1)


def decode_kmer_words(words_row: np.ndarray, k: int) -> str:
    """One key-word row back to the k-mer string (for dumpref output)."""
    val = 0
    for j in range(words_row.size - 1, -1, -1):
        val = (val << 32) | int(words_row[j])
    out = []
    for j in range(k):
        out.append("ACGT"[(val >> (2 * (k - 1 - j))) & 3])
    return "".join(out)


def decode_kmer(lo: int, hi: int, k: int) -> str:
    """(lo, hi) pair back to the k-mer string -- k <= 31 back-compat form."""
    return decode_kmer_words(np.asarray([lo, hi], dtype=_U64), k)


@dataclass
class KmerIndex:
    """Immutable array-form k-mer database over a set of genome records."""

    k: int
    # per input record (never filtered; EXTSIM marks records instead)
    descriptions: List[str]
    record_lengths: np.ndarray          # int64 [R]
    kept: np.ndarray                    # bool  [R] (EXTSIM filtering)
    # distinct k-mers (sorted key order); little-word columns, nw >= 2
    kmer_words: np.ndarray              # uint32 [U, nw]
    first_seen: np.ndarray              # int64  [U] original global scan index
    # CSR postings by kmer id, scan order inside each k-mer
    post_offsets: np.ndarray            # int64 [U+1]
    post_record: np.ndarray             # int32 [P]
    post_pos: np.ndarray                # int64 [P]
    # genome-set table
    set_id: np.ndarray                  # int32 [U]
    set_masks: np.ndarray               # uint8 [S, ceil(R/8)] record-bitmask
    set_sizes: np.ndarray               # int32 [S] distinct records per set
    similarity_info: Optional[Dict[str, Dict[str, object]]] = None

    @property
    def kmer_lo(self) -> np.ndarray:
        """Low key words -- with ``kmer_hi`` the full key iff k <= 31."""
        return self.kmer_words[:, 0]

    @property
    def kmer_hi(self) -> np.ndarray:
        return self.kmer_words[:, 1]

    def sort_keys(self) -> np.ndarray:
        """Sortable per-k-mer keys (uint64 or byte strings), sorted order."""
        return sort_keys_from_words(self.kmer_words)

    @property
    def num_kmers(self) -> int:
        return int(self.kmer_words.shape[0])

    @property
    def num_records(self) -> int:
        return len(self.descriptions)

    @property
    def num_sets(self) -> int:
        return int(self.set_sizes.size)

    def genome_counts(self) -> np.ndarray:
        """Distinct-record count per k-mer (the reference's
        ``len(self.kmers[kmer])``)."""
        return self.set_sizes[self.set_id]

    def display_order(self) -> np.ndarray:
        """K-mer ids in the reference's dict-insertion (first-seen) order."""
        return np.argsort(self.first_seen, kind="stable")

    def records_of_kmer(self, kid: int) -> np.ndarray:
        """Record ids of one k-mer in insertion (genome input) order."""
        sl = self.post_record[self.post_offsets[kid]: self.post_offsets[kid + 1]]
        _, first = np.unique(sl, return_index=True)
        return sl[np.sort(first)]

    def positions_of(self, kid: int, record: int) -> np.ndarray:
        sl = slice(self.post_offsets[kid], self.post_offsets[kid + 1])
        mask = self.post_record[sl] == record
        return self.post_pos[sl][mask]

    def kmer_string(self, kid: int) -> str:
        return decode_kmer_words(self.kmer_words[kid], self.k)


def _dedupe_sets_by_pairs(
    inverse: np.ndarray,
    record_of_occ: np.ndarray,
    num_kmers: int,
    num_records: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact set dedupe from unique (kmer, record) pairs.

    Used when record bitmasks are wide: sorting [num_kmers, R/8] mask rows
    (np.unique axis=0) is O(num_kmers * R/8 * log) and dominated the
    G=4096 build.  Here k-mers are bucketed by set cardinality d and each
    [n_d, d] record matrix is deduped separately -- total work is linear
    in the number of unique pairs, independent of R."""
    gbytes = max((num_records + 7) // 8, 1)
    pairkey = inverse.astype(np.int64) * np.int64(num_records) + \
        record_of_occ.astype(np.int64)
    pk = np.unique(pairkey)
    kid_u = pk // num_records
    rec_u = (pk % num_records).astype(np.int32)
    sizes = np.bincount(kid_u, minlength=num_kmers).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    set_id = np.zeros(num_kmers, dtype=np.int32)
    mask_rows: List[np.ndarray] = []
    size_rows: List[np.ndarray] = []
    next_sid = 0
    for d in np.unique(sizes):
        if d == 0:
            continue  # every built k-mer has >= 1 occurrence
        kids = np.flatnonzero(sizes == d)
        mat = rec_u[offsets[kids][:, None] + np.arange(d)[None, :]]
        uniq, inv = np.unique(mat, axis=0, return_inverse=True)
        set_id[kids] = next_sid + inv.astype(np.int32).reshape(-1)
        rows = np.zeros((uniq.shape[0], gbytes), dtype=np.uint8)
        np.bitwise_or.at(
            rows,
            (
                np.repeat(np.arange(uniq.shape[0]), d),
                (uniq >> 3).reshape(-1).astype(np.int64),
            ),
            np.uint8(1) << (uniq & 7).reshape(-1).astype(np.uint8),
        )
        mask_rows.append(rows)
        size_rows.append(np.full(uniq.shape[0], d, dtype=np.int32))
        next_sid += uniq.shape[0]
    if mask_rows:
        set_masks = np.concatenate(mask_rows, axis=0)
        set_sizes = np.concatenate(size_rows)
    else:
        set_masks = np.zeros((0, gbytes), dtype=np.uint8)
        set_sizes = np.zeros(0, dtype=np.int32)
    return set_id, set_masks, set_sizes


def _build_set_table(
    inverse: np.ndarray,
    record_of_occ: np.ndarray,
    num_kmers: int,
    num_records: int,
    presorted: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-k-mer record bitmasks, deduplicated into a set table.

    ``presorted``: occurrences are already grouped by kmer id (``inverse``
    nondecreasing), enabling the reduceat fast path."""
    gbytes = max((num_records + 7) // 8, 1)
    if gbytes > 8:
        # wide masks: the row-sort dedupe below is superlinear in R;
        # the pair-bucketed dedupe is exact and R-independent
        return _dedupe_sets_by_pairs(
            inverse, record_of_occ, num_kmers, num_records)
    masks = np.zeros((num_kmers, gbytes), dtype=np.uint8)
    if inverse.size and presorted and gbytes <= 16:
        # occurrences arrive grouped by kmer id (the _assemble key sort),
        # so per-kmer ORs are column-wise reduceat calls -- C-speed,
        # unlike the scalar ufunc.at loop
        starts = np.flatnonzero(
            np.concatenate([[True], inverse[1:] != inverse[:-1]]))
        byte_s = (record_of_occ >> 3).astype(np.int16)
        bits_s = np.uint8(1) << (record_of_occ & 7).astype(np.uint8)
        kid_of_group = inverse[starts]
        for c in range(gbytes):
            vals = np.where(byte_s == c, bits_s, np.uint8(0))
            masks[kid_of_group, c] = np.bitwise_or.reduceat(vals, starts)
    elif inverse.size:
        np.bitwise_or.at(
            masks,
            (inverse, (record_of_occ >> 3).astype(np.int64)),
            (np.uint8(1) << (record_of_occ & 7).astype(np.uint8)),
        )
    if gbytes <= 8 and num_kmers:
        # dedupe via a uint64 view: one argsort instead of unique(axis=0)
        padded = np.zeros((num_kmers, 8), dtype=np.uint8)
        padded[:, :gbytes] = masks
        as64 = padded.view(np.uint64)[:, 0]
        order = np.argsort(as64, kind="stable")
        sk = as64[order]
        new = np.empty(num_kmers, dtype=bool)
        new[0] = True
        new[1:] = sk[1:] != sk[:-1]
        gid = np.cumsum(new) - 1
        set_id = np.empty(num_kmers, dtype=np.int32)
        set_id[order] = gid.astype(np.int32)
        set_masks = masks[order[new]]
    else:
        set_masks, set_id = np.unique(masks, axis=0, return_inverse=True)
        set_id = set_id.astype(np.int32).reshape(-1)
    set_sizes = np.unpackbits(set_masks, axis=1).sum(axis=1).astype(np.int32)
    return set_id, set_masks, set_sizes


def build_index(
    genomes: GenomeArrays, k: int, chunk_bases: int = 1 << 24
) -> KmerIndex:
    """Scan all genome records and assemble the array index.

    Very long records are scanned in ``chunk_bases``-sized chunks with a
    (k-1)-base halo so window extraction is embarrassingly parallel and
    peak memory stays bounded (SURVEY.md §5.7: the sequence-parallel
    analog for genome streams).

    For k <= 31 the whole assembly runs in the native builder
    (io/csrc/kmer_build.cpp: rolling encode + multithreaded radix sort +
    set-table dedupe); the numpy path below is the any-k fallback and the
    differential oracle for it (tests/test_torch_host.py)."""
    from shotgun_tpu_torch.io import native as _native

    nat = _native.build_kmer_index(genomes.codes, genomes.offsets, k)
    if nat is not None:
        return KmerIndex(
            k=k,
            descriptions=genomes.descriptions,
            record_lengths=np.diff(genomes.offsets).astype(np.int64),
            kept=np.ones(genomes.num_records, dtype=bool),
            **nat,
        )

    occ_words: List[np.ndarray] = []
    occ_rec: List[np.ndarray] = []
    occ_pos: List[np.ndarray] = []
    record_lengths = np.diff(genomes.offsets)
    nw = num_key_words(k)
    for r in range(genomes.num_records):
        codes = genomes.record_codes(r)
        for chunk_start in range(0, max(codes.size, 1), chunk_bases):
            chunk = codes[chunk_start: chunk_start + chunk_bases + k - 1]
            words, valid = rolling_encode_words(chunk, k)
            if words.shape[0] == 0:
                continue
            idx = np.nonzero(valid)[0]
            occ_words.append(words[idx])
            occ_rec.append(np.full(idx.size, r, dtype=np.int32))
            occ_pos.append(idx.astype(np.int64) + chunk_start)

    if occ_words:
        all_words = np.concatenate(occ_words, axis=0)
        all_rec = np.concatenate(occ_rec)
        all_pos = np.concatenate(occ_pos)
    else:
        all_words = np.zeros((0, nw), dtype=_U32)
        all_rec = np.zeros(0, dtype=np.int32)
        all_pos = np.zeros(0, dtype=np.int64)

    return _assemble(
        k, genomes.descriptions, record_lengths,
        all_words, all_rec, all_pos,
        original_first_seen=None,
    )


def _assemble(
    k: int,
    descriptions: List[str],
    record_lengths: np.ndarray,
    all_words: np.ndarray,
    all_rec: np.ndarray,
    all_pos: np.ndarray,
    original_first_seen: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> KmerIndex:
    keys = sort_keys_from_words(all_words)
    num_occ = keys.size
    nw = all_words.shape[1]
    if num_occ:
        # one stable argsort yields everything: unique keys, inverse map,
        # CSR postings in scan order, and first-seen indices (the stable
        # sort keeps the earliest occurrence first within each key group)
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        new = np.empty(num_occ, dtype=bool)
        new[0] = True
        new[1:] = sk[1:] != sk[:-1]
        num_kmers = int(new.sum())
        gid_sorted = np.cumsum(new, dtype=np.int64) - 1
        uniq_rows = order[new]
        uniq_words = all_words[uniq_rows]
        first_seen = uniq_rows.astype(np.int64)
        post_record = all_rec[order]
        post_pos = all_pos[order]
        group_starts = np.flatnonzero(new)
        post_offsets = np.concatenate(
            [group_starts, [num_occ]]).astype(np.int64)
    else:
        uniq_words = np.zeros((0, nw), dtype=_U32)
        num_kmers = 0
        first_seen = np.zeros(0, dtype=np.int64)
        post_record = all_rec
        post_pos = all_pos
        post_offsets = np.zeros(1, dtype=np.int64)

    if original_first_seen is not None:
        # carry over first-seen ranks from the pre-filter index
        orig_keys, orig_fs = original_first_seen
        if num_kmers:
            first_seen = orig_fs[
                np.searchsorted(orig_keys, sk[new])]

    if num_occ:
        # occurrences are grouped by kmer id in the sorted domain, so the
        # set table builds with reduceat (set ids are per-kmer either way)
        set_id, set_masks, set_sizes = _build_set_table(
            gid_sorted, post_record, num_kmers,
            len(descriptions), presorted=True,
        )
    else:
        set_id, set_masks, set_sizes = _build_set_table(
            np.zeros(0, dtype=np.int64), all_rec, num_kmers,
            len(descriptions),
        )

    return KmerIndex(
        k=k,
        descriptions=descriptions,
        record_lengths=np.asarray(record_lengths, dtype=np.int64),
        kept=np.ones(len(descriptions), dtype=bool),
        kmer_words=np.ascontiguousarray(uniq_words),
        first_seen=first_seen,
        post_offsets=post_offsets,
        post_record=post_record,
        post_pos=post_pos,
        set_id=set_id,
        set_masks=set_masks,
        set_sizes=set_sizes,
    )


def filter_records(index: KmerIndex, kept_record_ids: np.ndarray) -> KmerIndex:
    """Drop postings of non-kept records, preserving original first-seen
    order of surviving k-mers (the reference deletes dict entries in place,
    so remaining keys keep their original insertion rank --
    reference kmer.py:232-243)."""
    kept_mask = np.zeros(index.num_records, dtype=bool)
    kept_mask[kept_record_ids] = True

    # expand CSR back into occurrence arrays and filter
    kmer_of_occ = np.repeat(
        np.arange(index.num_kmers, dtype=np.int64), np.diff(index.post_offsets)
    )
    occ_keep = kept_mask[index.post_record]
    kmer_of_occ = kmer_of_occ[occ_keep]
    rec = index.post_record[occ_keep]
    pos = index.post_pos[occ_keep]
    words = index.kmer_words[kmer_of_occ]

    out = _assemble(
        index.k, index.descriptions, index.record_lengths,
        words, rec, pos,
        original_first_seen=(index.sort_keys(), index.first_seen),
    )
    out.kept = kept_mask
    out.similarity_info = index.similarity_info
    return out
