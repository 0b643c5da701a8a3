"""``PseudoAlignment`` for the port: streamed dumpalign aggregation
(counterpart of ``shotgun_tpu/aligner.py``, the ``store_reads=False``
stream route and its container fallback).

Chunks come from the shared native fill (``FASTAQStream.chunks_packed``:
codes 2-bit packed, quality only when a gate reads it) on a producer
thread, go through pinned host memory to the device with non-blocking
copies, and fold into one device-resident ``FoldCarry`` that is fetched
once a run.  The integer host state then reconstructs the reference's
dumpalign JSON, dict orders and downgrade double count included.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from shotgun_tpu.errors import UserInputError
from shotgun_tpu.io.native import LmaxExceeded
from shotgun_tpu.io.packing import pack_reads
from shotgun_tpu.io.records import SeqRecord
from shotgun_tpu_torch.models.pipeline import (
    FOLD_INF,
    FoldCarry,
    align_fold_batch,
    init_fold_carry,
)
from shotgun_tpu_torch.ops.encode import pack_codes_2bit
from shotgun_tpu_torch.reference import KmerReference

_INF = np.iinfo(np.int64).max

#: one chunk as the native packed fill yields it: (codes_2bit [C, L/4] u8,
#: qual [C, L] u8 (or a dummy), lengths [C] i32, rows filled)
Chunk = Tuple[np.ndarray, np.ndarray, np.ndarray, int]


def _prefetch_iter(it: Iterable, depth: int = 2) -> Iterator:
    """Run an iterator on a producer thread, yielding through a bounded
    queue.  The native chunk fills release the GIL, so the producer
    overlaps the consumer's uploads and launches; ``depth`` bounds the
    filled-but-unconsumed chunks (each chunk is a fresh buffer).
    Exceptions from the iterator (e.g. LmaxExceeded) re-raise at the
    consumer's next pull.  If the consumer abandons the loop, the
    ``finally`` cancels the producer and drains the queue so its bounded
    ``put`` never blocks forever; the producer closes the source
    iterator itself, since it is the thread driving it."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    holder: List[BaseException] = []
    cancelled = threading.Event()

    def cancellable_put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not cancellable_put(item):
                    return
        except BaseException as exc:  # re-raised on the consumer side
            holder.append(exc)
        finally:
            close = getattr(it, "close", None)
            try:
                if close is not None:
                    close()
            except Exception as exc:
                holder.append(exc)
            cancellable_put(done)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if holder:
                    raise holder[0]
                return
            yield item
    finally:
        cancelled.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


def _auto_batch(est_reads: int) -> int:
    """batch_size=0 (auto): the large batch for big inputs, a small one
    for small inputs (output does not depend on the batch size)."""
    return 32768 if est_reads >= 131_072 else 2048


def _lpad(max_len: int, k: int) -> int:
    """Row stride: the read length rounded up to a multiple of 32 (a
    multiple of 4 for the 2-bit packing)."""
    return ((max(max_len, k) + 31) // 32) * 32


class PseudoAlignment:
    """Aggregates dumpalign read alignments against one KmerReference on
    one device."""

    def __init__(self, kmer_reference: KmerReference,
                 device: torch.device) -> None:
        self.kmer_reference = kmer_reference
        self.device = torch.device(device)
        r = kmer_reference.index.num_records
        self.filtered_quality_reads = 0
        self.filtered_quality_kmers = 0
        self.filtered_hr_kmers = 0
        self._n_unique = 0
        self._n_ambiguous = 0
        self._n_unmapped = 0
        self._unique_by_rec = np.zeros(r, dtype=np.int64)
        self._amb_by_rec = np.zeros(r, dtype=np.int64)
        self._first_batch = np.full(r, _INF, dtype=np.int64)
        self._first_key = np.full(r, _INF, dtype=np.int64)
        self._batch_no = 0

        self.filter_read_quality_flag = False
        self.filter_kmer_quality_flag = False
        self.filter_max_genomes_flag = False

    # -- device runs ----------------------------------------------------------

    def _check_args(self, m, p, min_read_quality, min_kmer_quality,
                    max_genomes) -> None:
        """Validate m and p, and record which gates the summary reports."""
        if not isinstance(m, int) or not isinstance(p, int):
            raise TypeError("m and p must be ints")
        if m < 0:
            raise UserInputError("m must be bigger than or equal to 0")
        if min_read_quality is not None:
            self.filter_read_quality_flag = True
        if min_kmer_quality is not None:
            self.filter_kmer_quality_flag = True
        if max_genomes is not None:
            self.filter_max_genomes_flag = True

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host chunk -> device: staged in pinned memory and copied
        without blocking on CUDA (the caching host allocator keeps the
        pinned block alive until the copy has run)."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _fold_chunks(self, chunks: Iterable[Chunk], m, p, min_read_quality,
                     min_kmer_quality, max_genomes) -> Tuple[FoldCarry, int]:
        """Align and fold every chunk into a fresh device carry."""
        ref = self.kmer_reference
        k = ref.index.k
        probe_tab = ref.device_probe_tables(self.device)
        member = ref.set_member_device(self.device)
        use_qual = min_read_quality is not None or min_kmer_quality is not None
        carry = init_fold_carry(member.shape[1], self.device,
                                start_batch=self._batch_no)
        n_batches = 0
        for codes_p, qual, lengths, _got in chunks:
            carry = align_fold_batch(
                carry, probe_tab, member,
                self._upload(codes_p),
                self._upload(qual) if use_qual else None,
                self._upload(lengths),
                m, p, min_read_quality or 0, min_kmer_quality or 0,
                max_genomes or 0,
                k=k,
                has_mrq=min_read_quality is not None,
                has_mkq=min_kmer_quality is not None,
                has_mg=max_genomes is not None,
            )
            n_batches += 1
        return carry, n_batches

    def _finish_run(self, carry: FoldCarry, n_batches: int) -> None:
        """The run's one fetch, folded into the host totals."""
        host = FoldCarry(*(t.cpu().numpy() for t in carry))
        self._merge_fold_carry(host, self.kmer_reference.index.num_records)
        self._batch_no += n_batches

    def align_stream(
        self,
        stream,
        m: int = 1,
        p: int = 1,
        min_read_quality: Optional[int] = None,
        min_kmer_quality: Optional[int] = None,
        max_genomes: Optional[int] = None,
        batch_size: int = 1024,
    ) -> None:
        """Align a ``FASTAQStream`` (dumpalign: only the aggregation is
        kept).  The native fill validates the input while it packs; a
        validation failure raises ``NativeParseError`` and the caller
        re-reads the file through the regex engine for the reference's
        exact errors."""
        self._check_args(m, p, min_read_quality, min_kmer_quality, max_genomes)
        b = batch_size or _auto_batch(stream.est_records())
        use_qual = min_read_quality is not None or min_kmer_quality is not None
        stream.start_validation()

        # in lazy mode max_len is a first-record peek; a longer record
        # midway raises LmaxExceeded and the pass restarts at twice the
        # stride (rare: reads are near-uniform in length)
        lpad = _lpad(stream.max_len, self.kmer_reference.index.k)
        while True:
            try:
                carry, n_batches = self._fold_chunks(
                    _prefetch_iter(stream.chunks_packed(b, lpad, use_qual)),
                    m, p, min_read_quality, min_kmer_quality, max_genomes)
                break
            except LmaxExceeded:
                lpad *= 2
        stream.finish_validation()  # NativeParseError discards the run
        self._finish_run(carry, n_batches)

    def align_reads_from_container(
        self,
        reads_container: Iterable[SeqRecord],
        m: int = 1,
        p: int = 1,
        min_read_quality: Optional[int] = None,
        min_kmer_quality: Optional[int] = None,
        max_genomes: Optional[int] = None,
        batch_size: int = 1024,
    ) -> None:
        """Align parsed records (the regex-engine fallback route): packed
        on the host into the same chunks the stream yields."""
        self._check_args(m, p, min_read_quality, min_kmer_quality, max_genomes)
        if hasattr(reads_container, "to_read_batch"):
            batch = reads_container.to_read_batch()
        else:
            batch = pack_reads(list(reads_container))
        n = batch.num_reads
        b = batch_size or _auto_batch(n)
        lpad = _lpad(batch.max_len, self.kmer_reference.index.k)
        use_qual = min_read_quality is not None or min_kmer_quality is not None
        dummy_qual = np.zeros((b, 1), dtype=np.uint8)

        def chunks() -> Iterator[Chunk]:
            for start in range(0, n, b):
                rows = min(b, n - start)
                codes = np.zeros((b, lpad), dtype=np.uint8)
                codes[:rows, : batch.max_len] = batch.codes[start: start + rows]
                qual = dummy_qual
                if use_qual:
                    qual = np.zeros((b, lpad), dtype=np.uint8)
                    qual[:rows, : batch.max_len] = batch.qual[start: start + rows]
                lengths = np.zeros(b, dtype=np.int32)
                lengths[:rows] = batch.lengths[start: start + rows]
                yield pack_codes_2bit(codes), qual, lengths, rows

        carry, n_batches = self._fold_chunks(
            chunks(), m, p, min_read_quality, min_kmer_quality, max_genomes)
        self._finish_run(carry, n_batches)

    def _merge_fold_carry(self, carry: FoldCarry, r: int) -> None:
        """Fold a fetched FoldCarry (numpy arrays) into the host totals."""
        cnt = [int(x) for x in np.asarray(carry.counters)]
        self._n_unique += cnt[0]
        self._n_ambiguous += cnt[1]
        self._n_unmapped += cnt[2]
        if self.filter_read_quality_flag:
            self.filtered_quality_reads += cnt[3]
        if self.filter_kmer_quality_flag:
            self.filtered_quality_kmers += cnt[4]
        if self.filter_max_genomes_flag:
            self.filtered_hr_kmers += cnt[5]
        self._unique_by_rec += np.asarray(carry.unique_by_rec, dtype=np.int64)[:r]
        self._amb_by_rec += np.asarray(carry.amb_by_rec, dtype=np.int64)[:r]
        fb = np.asarray(carry.first_batch, dtype=np.int64)[:r]
        fk = np.asarray(carry.first_key, dtype=np.int64)[:r]
        fresh = (fb < FOLD_INF) & (self._first_batch == _INF)
        self._first_batch[fresh] = fb[fresh]
        self._first_key[fresh] = fk[fresh]

    # -- summary (reference kmer.py:622-657) ----------------------------------

    def get_summary(self) -> Dict[str, Any]:
        stats: Dict[str, int] = {
            "unique_mapped_reads": self._n_unique,
            "ambiguous_mapped_reads": self._n_ambiguous,
            "unmapped_reads": self._n_unmapped,
        }
        if self.filter_read_quality_flag:
            stats["filtered_quality_reads"] = self.filtered_quality_reads
        if self.filter_kmer_quality_flag:
            stats["filtered_quality_kmers"] = self.filtered_quality_kmers
        if self.filter_max_genomes_flag:
            stats["filtered_hr_kmers"] = self.filtered_hr_kmers

        descs = self.kmer_reference.index.descriptions
        order = np.lexsort((self._first_key, self._first_batch))
        genome_mapping: Dict[str, Dict[str, int]] = {}
        for rec in order:
            if self._first_batch[rec] == _INF:
                continue
            entry = genome_mapping.setdefault(
                descs[rec], {"unique_reads": 0, "ambiguous_reads": 0})
            entry["unique_reads"] += int(self._unique_by_rec[rec])
            entry["ambiguous_reads"] += int(self._amb_by_rec[rec])
        return {"Statistics": stats, "Summary": genome_mapping}
