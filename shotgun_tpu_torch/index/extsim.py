"""EXTSIM, the greedy filter of highly similar genomes, with its overlap
matrix on the device (counterpart of ``shotgun_tpu/index/extsim.py``).

The host parts are copies of the JAX package's: the unique (k-mer,
identifier) pairs (``_ident_pairs``), the float32 host product below
``_DEVICE_MIN_G`` identifiers (``overlap_matrix_host``) and the record
filter (``build.filter_records``).  From ``_DEVICE_MIN_G`` identifiers on,
the overlap counts O = M @ M.T of the 0/1 membership matrix M [G, U] run
on the device, one k-mer chunk of M at a time: the chunk is scattered
into a float32 [G, C] one-hot and multiplied by its transpose with TF32
off, so every product and partial sum is an exact integer (at most C =
8192 per chunk, far below 2^24), and the chunks sum in int64.  The JAX
package runs the same sweep in bf16 with float32 accumulation on the
MXU.  The greedy keep loop stays on the host, as there.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from shotgun_tpu_torch.index.build import KmerIndex, filter_records

__all__ = ["apply_similarity_filter", "overlap_matrix", "overlap_matrix_device",
           "overlap_matrix_host"]

#: identifiers below this count use the host float32 product; at or above
#: it the chunks run on the device (the JAX package's split)
_DEVICE_MIN_G = int(os.environ.get("SHOTGUN_TPU_EXTSIM_DEVICE_MIN_G", "256"))
_CHUNK = 1 << 13


def _ident_pairs(index: KmerIndex) -> Tuple[List[str], np.ndarray, np.ndarray, np.ndarray]:
    """(idents, ident of record, kmer ids, ident ids) -- the unique
    (k-mer, identifier) membership pairs, sorted k-mer-major."""
    kmer_of_occ = np.repeat(
        np.arange(index.num_kmers, dtype=np.int64), np.diff(index.post_offsets)
    )
    ident_of_rec: Dict[str, int] = {}
    ident_idx = np.empty(max(index.num_records, 1), dtype=np.int64)
    idents: List[str] = []
    for rec, desc in enumerate(index.descriptions):
        if desc not in ident_of_rec:
            ident_of_rec[desc] = len(idents)
            idents.append(desc)
        ident_idx[rec] = ident_of_rec[desc]

    n_id = max(len(idents), 1)
    pairs = np.unique(
        kmer_of_occ * n_id + ident_idx[index.post_record]
    )
    return (
        idents,
        ident_idx[: index.num_records],
        pairs // n_id,
        (pairs % n_id).astype(np.int32),
    )


def overlap_matrix_host(
    kmer_u: np.ndarray, ident_u: np.ndarray, g: int, num_kmers: int
) -> np.ndarray:
    """Chunked float32 matmul on host (exact: 0/1 inputs, counts < 2^24)."""
    out = np.zeros((g, g), dtype=np.float64)
    for c0 in range(0, max(num_kmers, 1), _CHUNK):
        s0, s1 = np.searchsorted(kmer_u, [c0, c0 + _CHUNK])
        if s0 == s1:
            continue
        mc = np.zeros((g, min(_CHUNK, num_kmers - c0)), dtype=np.float32)
        mc[ident_u[s0:s1], kmer_u[s0:s1] - c0] = 1.0
        out += (mc @ mc.T).astype(np.float64)
    return np.rint(out).astype(np.int64)


@contextlib.contextmanager
def _exact_fp32_matmul() -> Iterator[None]:
    """float32 products in full float32: TF32 off for the block, restored
    after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def overlap_matrix_device(kmer_u: np.ndarray, ident_u: np.ndarray, g: int,
                          num_kmers: int, device: torch.device) -> np.ndarray:
    """[G, G] int64 counts of k-mers shared by each pair of identifiers
    (the diagonal: each identifier's k-mer count), on ``device``.  The
    pairs ship once; each chunk of ``_CHUNK`` k-mers is one scatter and
    one float32 product."""
    kmer_d = torch.from_numpy(np.ascontiguousarray(kmer_u, dtype=np.int64)).to(device)
    ident_d = torch.from_numpy(np.ascontiguousarray(ident_u, dtype=np.int64)).to(device)
    n_chunks = max(-(-num_kmers // _CHUNK), 1)
    bounds = np.searchsorted(kmer_u, np.arange(n_chunks + 1) * _CHUNK).tolist()
    acc = torch.zeros((g, g), dtype=torch.int64, device=device)
    mc = torch.empty((g, _CHUNK), dtype=torch.float32, device=device)
    with _exact_fp32_matmul():
        for c in range(n_chunks):
            s0, s1 = bounds[c], bounds[c + 1]
            if s0 == s1:
                continue
            mc.zero_()
            mc[ident_d[s0:s1], kmer_d[s0:s1] - c * _CHUNK] = 1.0
            acc += torch.mm(mc, mc.T).to(torch.int64)
    return acc.cpu().numpy()


def overlap_matrix(kmer_u: np.ndarray, ident_u: np.ndarray, g: int,
                   num_kmers: int, device: torch.device) -> np.ndarray:
    """The JAX package's split: the host product below ``_DEVICE_MIN_G``
    identifiers, the device one from there on."""
    if g >= _DEVICE_MIN_G:
        return overlap_matrix_device(kmer_u, ident_u, g, num_kmers, device)
    return overlap_matrix_host(kmer_u, ident_u, g, num_kmers)


def apply_similarity_filter(index: KmerIndex, threshold: float,
                            device: torch.device) -> KmerIndex:
    """The whole EXTSIM pipeline (reference kmer.py:152-263): a filtered
    index with ``similarity_info`` set.  Identifiers sort ascending by
    (unique k-mers, total k-mers, genome length, order), the last record
    of an identifier giving its length and order; each is dropped when
    its overlap coefficient |A & B| / min(|A|, |B|) with a kept one is
    strictly above ``threshold`` (the first such kept one is named)."""
    idents, _ident_of_rec, kmer_u, ident_u = _ident_pairs(index)
    g = len(idents)
    record_count = index.genome_counts()  # distinct records per k-mer

    totals = np.bincount(ident_u, minlength=g).astype(np.int64)
    uniq_mask = record_count[kmer_u] == 1
    uniques = np.bincount(ident_u[uniq_mask], minlength=g).astype(np.int64)

    stats: Dict[str, Tuple[int, int, int, int]] = {}
    ident_pos = {d: i for i, d in enumerate(idents)}
    for order, desc in enumerate(index.descriptions):
        i = ident_pos[desc]
        stats[desc] = (int(uniques[i]), int(totals[i]),
                       int(index.record_lengths[order]), order)

    overlap = overlap_matrix(kmer_u, ident_u, g, index.num_kmers, device)

    processed = sorted(stats.items(), key=lambda item: item[1])

    kept_ids = np.empty(g, dtype=np.int64)
    n_kept = 0
    similarity_info: Dict[str, Dict[str, object]] = {}
    for ident, (unique, total, length, _order) in processed:
        i = ident_pos[ident]
        verdict = None
        if n_kept:
            kl = kept_ids[:n_kept]
            denom = np.minimum(totals[i], totals[kl]).astype(np.float64)
            scores = np.divide(
                overlap[i, kl].astype(np.float64), denom,
                out=np.zeros(n_kept, dtype=np.float64), where=denom > 0)
            over = scores > threshold
            if over.any():
                j = int(np.argmax(over))  # first kept genome over threshold
                verdict = (idents[int(kl[j])], float(scores[j]))
        if verdict is None:
            similarity_info[ident] = {
                "kept": "yes",
                "unique_kmers": unique,
                "total_kmers": total,
                "genome_length": length,
                "similar_to": "NA",
                "similarity_score": "NA",
            }
            kept_ids[n_kept] = i
            n_kept += 1
        else:
            similarity_info[ident] = {
                "kept": "no",
                "unique_kmers": unique,
                "total_kmers": total,
                "genome_length": length,
                "similar_to": verdict[0],
                "similarity_score": verdict[1],
            }

    keep = {ident for ident, info in similarity_info.items() if info["kept"] == "yes"}
    kept_records = np.asarray(
        [r for r, desc in enumerate(index.descriptions) if desc in keep],
        dtype=np.int64)
    out = filter_records(index, kept_records)
    out.similarity_info = similarity_info
    return out
