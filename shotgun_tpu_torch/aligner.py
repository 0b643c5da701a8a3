"""``Read`` and ``PseudoAlignment`` for the port (counterpart of
``shotgun_tpu/aligner.py``): the single-read API on the host, and
streamed or packed alignment on the device with the dumpalign aggregation,
the align task's read store and the ``.aln`` file.

Chunks come from the shared native fill (``FASTAQStream.chunks_packed``:
codes 2-bit packed, quality only when a gate reads it) on a producer
thread, go through pinned host memory to the device with non-blocking
copies, and fold into one device-resident ``FoldCarry`` that is fetched
once a run.  The integer host state then reconstructs the reference's
dumpalign JSON, dict orders and downgrade double count included.

With ``store_reads`` each batch's mapping lists are compacted on the
device (``models.pipeline.store_lists``) and copied to pinned host memory
without blocking: a byte of mapping type and a list length per read, and
the lists themselves.  The host then does only what needs strings: the
read ids and the duplicate check.

``align_packed_reads(mesh=...)`` shards each batch over a device mesh
(``parallel``): the merged per-batch results fold into the same carry, so
the summary is the single-device one.
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading
from collections import namedtuple
from enum import Enum
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from shotgun_tpu_torch.errors import UserInputError
from shotgun_tpu_torch.io import native
from shotgun_tpu_torch.io.native import LmaxExceeded, NativeParseError
from shotgun_tpu_torch.index.build import rolling_encode_words, sort_keys_from_words
from shotgun_tpu_torch.io.packing import ReadBatch, encode_bases, pack_reads
from shotgun_tpu_torch.io.records import SeqRecord
from shotgun_tpu_torch.models.pipeline import (
    FOLD_INF,
    FoldCarry,
    StoreLists,
    _fold_agg,
    aggregate_batch,
    align_batch,
    init_fold_carry,
    store_lists,
    unmapped_batch,
)
from shotgun_tpu_torch.ops.encode import pack_codes_2bit
from shotgun_tpu_torch.parallel.mesh import (
    Mesh,
    align_aggregate_sharded,
    replicate,
    shard_read_arrays,
)
from shotgun_tpu_torch.parallel.table_sharded import (
    align_aggregate_table_sharded,
    device_put_sharded_table,
    shard_sorted_table,
)
from shotgun_tpu_torch.reference import PROBE_ENV, KDBFormatError, KmerReference
from shotgun_tpu_torch.routes import device_routes
from shotgun_tpu_torch.utils.device import resolve_device, upload
from shotgun_tpu_torch.utils.profiling import PROFILER, phase

_INF = np.iinfo(np.int64).max

#: one chunk as the native packed fill yields it: (codes_2bit [C, L/4] u8,
#: qual [C, L] u8 (or a dummy), lengths [C] i32, rows filled)
Chunk = Tuple[np.ndarray, np.ndarray, np.ndarray, int]


class NotValidatingUniqueMapping(Exception):
    def __init__(self, message: str) -> None:
        super().__init__(message)


class AddingExistingRead(Exception):
    def __init__(self, message: str) -> None:
        super().__init__(message)


class ReadMappingType(Enum):
    UNMAPPED = 1
    UNIQUELY_MAPPED = 2
    AMBIGUOUSLY_MAPPED = 3


class KmerSpecifity(Enum):
    SPECIFIC = 1
    UNSPECIFIC = 2


ReadKmer = namedtuple("ReadKmer", ["specifity", "references"])
ReadMapping = namedtuple("ReadMapping", ["type", "genomes_mapped_to"])

# device mtype codes (models/pipeline.py) -> ReadMappingType
_MTYPE_FROM_CODE = {
    0: ReadMappingType.UNMAPPED,
    1: ReadMappingType.UNIQUELY_MAPPED,
    2: ReadMappingType.AMBIGUOUSLY_MAPPED,
}
_CODE_FROM_MTYPE = {v: k for k, v in _MTYPE_FROM_CODE.items()}


class Read:
    """One sequencing read, aligned on the host against the reference's
    index (reference kmer.py:357-526; the JAX package's ``Read``).  The
    single-read API and a readable specification of the batched path."""

    def __init__(self, fastaq_record: SeqRecord) -> None:
        self.identifier: str = fastaq_record.identifier
        self.mapping = ReadMapping(ReadMappingType.UNMAPPED, [])
        self.kmers: Dict[str, ReadKmer] = {}
        self._seq: str = fastaq_record["sequence"]
        self._qual: str = fastaq_record["quality_sequence"]
        self.num_quality_filtered_kmers: int = 0
        self.num_redundant_kmers: int = 0
        self._record_ids: List[int] = []  # the mapping list as record ids
        self._stored: Dict[int, bool] = {}  # k-mer id -> specific?
        self._ref: Optional[KmerReference] = None

    def mean_quality(self) -> float:
        return sum(map(ord, self._qual)) / len(self._qual)

    def kmer_quality(self, start: int, k: int) -> float:
        return sum(map(ord, self._qual[start: start + k])) / k

    def pseudo_align(
        self,
        kmer_reference: KmerReference,
        m: int = 1,
        p: int = 1,
        min_read_quality: Optional[int] = None,
        min_kmer_quality: Optional[int] = None,
        max_genomes: Optional[int] = None,
        debug: bool = False,
    ) -> ReadMappingType:
        if not (
            isinstance(kmer_reference, KmerReference)
            and isinstance(m, int)
            and isinstance(p, int)
            and (min_read_quality is None or isinstance(min_read_quality, int))
            and (min_kmer_quality is None or isinstance(min_kmer_quality, int))
            and (max_genomes is None or isinstance(max_genomes, int))
            and isinstance(debug, bool)
        ):
            raise TypeError(
                f"Invalid types given to pseudo align: {type(kmer_reference)}, "
                f"{type(p)}, {type(m)}, {type(debug)}")
        if m < 0:
            raise UserInputError("m must be bigger than or equal to 0")
        if min_read_quality is not None and self.mean_quality() < min_read_quality:
            return ReadMappingType.UNMAPPED

        self.extract_kmer_references(kmer_reference, min_kmer_quality, max_genomes)
        if not self._stored:
            return ReadMappingType.UNMAPPED
        if self.try_to_align_specific(m):
            if debug:
                print("[DEBUG pseudo_align]: After try_to_align_specific "
                      f"self.mapping: {self.mapping.type}")
            self.validate_unique_mappings(p)
            return self.mapping.type
        if debug:
            print("[DEBUG pseudo_align]: After try_to_align_specific "
                  f"self.mapping: {self.mapping.type}, mapped to: {self.mapping}")
        return ReadMappingType.AMBIGUOUSLY_MAPPED

    def extract_kmer_references(
        self,
        kmer_reference: KmerReference,
        min_kmer_quality: Optional[int] = None,
        max_genomes: Optional[int] = None,
    ) -> None:
        """Look every window up, apply the MKQ and max-genomes gates in
        window order, and keep the k-mers that pass by first occurrence
        (reference kmer.py:410-429)."""
        self._ref = kmer_reference
        idx = kmer_reference.index
        k = idx.k
        words, _ = rolling_encode_words(encode_bases(self._seq), k)
        keys = sort_keys_from_words(words)
        table_keys = idx.sort_keys()
        if keys.size and table_keys.size:
            pos = np.searchsorted(table_keys, keys)
            clamped = np.minimum(pos, table_keys.size - 1)
            hits = np.where(table_keys[clamped] == keys, clamped, -1)
        else:
            hits = np.full(keys.size, -1, dtype=np.int64)

        # the genome counts of the hit k-mers only: idx.genome_counts() is
        # a gather over every k-mer of the index
        hit_ids = hits[hits >= 0]
        genome_counts = dict(zip(hit_ids.tolist(),
                                 idx.set_sizes[idx.set_id[hit_ids]].tolist()))
        qual_ord = np.frombuffer(self._qual.encode("ascii"), dtype=np.uint8).astype(np.int32)
        qual_cs = np.concatenate([[0], np.cumsum(qual_ord)])

        self._stored = {}
        for w in range(hits.size):
            if min_kmer_quality is not None:
                if qual_cs[w + k] - qual_cs[w] < min_kmer_quality * k:
                    self.num_quality_filtered_kmers += 1
                    continue
            kid = int(hits[w])
            if kid < 0:
                continue
            if max_genomes is not None and genome_counts[kid] > max_genomes:
                self.num_redundant_kmers += 1
                continue
            if kid not in self._stored:
                self._stored[kid] = bool(genome_counts[kid] == 1)

        recs = kmer_reference._materialized_records()
        for kid, specific in self._stored.items():
            self.kmers[idx.kmer_string(kid)] = ReadKmer(
                specifity=(KmerSpecifity.SPECIFIC if specific
                           else KmerSpecifity.UNSPECIFIC),
                references={recs[r]: set(int(x) for x in idx.positions_of(kid, r))
                            for r in idx.records_of_kmer(kid)})

    def _genome_count_ids(self, map_count: bool = False) -> Dict[int, int]:
        """Per-record distinct-k-mer counts in insertion order, by record
        id (reference kmer.py:431-442)."""
        idx = self._ref.index
        counts: Dict[int, int] = {}
        for kid, specific in self._stored.items():
            if map_count and not specific:
                continue
            for r in idx.records_of_kmer(kid):
                r = int(r)
                counts[r] = counts.get(r, 0) + 1
        return counts

    def generate_genome_counts(self, map_count: bool = False):
        """The counts keyed by genome records (reference kmer.py:431-442)."""
        recs = self._ref._materialized_records()
        return {recs[r]: c for r, c in self._genome_count_ids(map_count).items()}

    def try_to_align_specific(self, m: int) -> bool:
        """The m-decision over specific k-mer counts (reference
        kmer.py:444-462)."""
        if m < 0:
            raise UserInputError("m must be non-negative")
        spec = self._genome_count_ids(map_count=True)
        recs = self._ref._materialized_records()
        if len(spec) == 1:
            self._set_mapping(ReadMappingType.UNIQUELY_MAPPED, [next(iter(spec))], recs)
            return True
        if len(spec) > 1:
            ranked = sorted(spec, key=lambda r: spec[r], reverse=True)
            if spec[ranked[0]] >= spec[ranked[1]] + m:
                self._set_mapping(ReadMappingType.UNIQUELY_MAPPED, [ranked[0]], recs)
                return True
        self._set_mapping(ReadMappingType.AMBIGUOUSLY_MAPPED, list(spec.keys()), recs)
        return False

    def validate_unique_mappings(self, p: int) -> None:
        """The p-validation: a downgrade to ambiguous lists the winner
        twice (reference kmer.py:464-480)."""
        if self.mapping.type != ReadMappingType.UNIQUELY_MAPPED or p < 0:
            return
        total = self._genome_count_ids(map_count=False)
        winner = self._record_ids[0]
        mt = total.get(winner, 0)
        if max(total.values(), default=0) - mt > p:
            amb = [winner] + [r for r, c in total.items() if c >= mt]
            self._set_mapping(ReadMappingType.AMBIGUOUSLY_MAPPED, amb,
                              self._ref._materialized_records())

    def _set_mapping(self, mtype: ReadMappingType, record_ids: List[int],
                     recs: List[SeqRecord]) -> None:
        self._record_ids = [int(r) for r in record_ids]
        self.mapping = ReadMapping(mtype, [recs[r] for r in self._record_ids])


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
            with phase("fill_wait"):
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


def _jax_record_width(r: int) -> int:
    """The JAX package's record axis for ``r`` records: its shape bucket
    (a power of two, at least 8; 2^24 steps past 2^24), its
    ``KmerReference._pad_rows``."""
    n = max(r, 8)
    if n <= 1 << 24:
        return 1 << (n - 1).bit_length()
    return -(-n // (1 << 24)) * (1 << 24)


def _lpad(max_len: int, k: int) -> int:
    """Row stride: the read length rounded up to a multiple of 32 (a
    multiple of 4 for the 2-bit packing)."""
    return ((max(max_len, k) + 31) // 32) * 32


class PseudoAlignment:
    """Aggregates read alignments against one KmerReference on one device
    (reference kmer.py:532-699), with the read store of the align task."""

    def __init__(self, kmer_reference: KmerReference,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        """``device`` (default the reference's) is where reads align."""
        self.kmer_reference = kmer_reference
        self.device = (kmer_reference.device if device is None
                       else torch.device(device))
        r = kmer_reference.index.num_records
        # read store: whole-batch blocks of mapping lists (only ever
        # concatenated: save, load and the summary never index per read)
        self._read_ids: List[str] = []
        self._mtypes: List[int] = []
        self._list_flat: List[np.ndarray] = []
        self._list_counts: List[int] = []
        self._seen_ids: set = set()
        # aggregation state
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
        # each mesh's probe tables, placed once: {key: per-device tables}
        self._mesh_tables: Dict[tuple, tuple] = {}

        self.filter_read_quality_flag = False
        self.filter_kmer_quality_flag = False
        self.filter_max_genomes_flag = False

    # -- single-read API (host) -----------------------------------------------

    def add_read(self, read: Read) -> None:
        """Store an aligned ``Read`` and count it, as one batch of one."""
        if read.identifier in self._seen_ids:
            raise AddingExistingRead(
                f"There already exists a read with identifier: {read.identifier}")
        self._seen_ids.add(read.identifier)
        self._read_ids.append(read.identifier)
        code = _CODE_FROM_MTYPE[read.mapping.type]
        self._mtypes.append(code)
        ids = np.asarray(read._record_ids, dtype=np.int64)
        self._list_flat.append(ids)
        self._list_counts.append(ids.size)
        self._fold_single(code, ids)

    def _fold_single(self, code: int, record_ids: np.ndarray) -> None:
        """Fold one read into the totals: its list position is its order
        key, its batch the next one."""
        if code == 1:
            self._n_unique += 1
        elif code == 2:
            self._n_ambiguous += 1
        else:
            self._n_unmapped += 1
        if code != 0:
            np.add.at(self._amb_by_rec if code == 2 else self._unique_by_rec,
                      record_ids, 1)
            for pos, r in enumerate(record_ids):
                if self._first_batch[r] == _INF:
                    self._first_batch[r] = self._batch_no
                    self._first_key[r] = pos
        self._batch_no += 1

    def add_read_from_read_record(
        self,
        read_record: SeqRecord,
        m: int = 1,
        p: int = 1,
        min_read_quality: Optional[int] = None,
        min_kmer_quality: Optional[int] = None,
        max_genomes: Optional[int] = None,
    ) -> None:
        """Align one record on the host (``Read.pseudo_align``) and add
        it; an MRQ-filtered read is counted, not stored."""
        if min_read_quality is not None:
            self.filter_read_quality_flag = True
        if min_kmer_quality is not None:
            self.filter_kmer_quality_flag = True
        if max_genomes is not None:
            self.filter_max_genomes_flag = True
        read = Read(read_record)
        if min_read_quality is not None and read.mean_quality() < min_read_quality:
            self.filtered_quality_reads += 1
            return
        read.pseudo_align(self.kmer_reference, m=m, p=p,
                          min_read_quality=min_read_quality,
                          min_kmer_quality=min_kmer_quality,
                          max_genomes=max_genomes)
        if min_kmer_quality is not None:
            self.filtered_quality_kmers += read.num_quality_filtered_kmers
        if max_genomes is not None:
            self.filtered_hr_kmers += read.num_redundant_kmers
        self.add_read(read)

    # -- device runs ----------------------------------------------------------

    def _check_args(self, m, p, min_read_quality, min_kmer_quality,
                    max_genomes) -> None:
        """Validate m and p, and the MKQ gate's k, and record which gates
        the summary reports."""
        if not isinstance(m, int) or not isinstance(p, int):
            raise TypeError("m and p must be ints")
        if m < 0:
            raise UserInputError("m must be bigger than or equal to 0")
        k = self.kmer_reference.index.k
        if min_kmer_quality is not None and k < 0:
            # a window of k < 0 bases has no quality sum (the JAX package
            # fails here too)
            raise UserInputError(f"--min-kmer-quality needs k >= 0, got k={k}")
        if min_read_quality is not None:
            self.filter_read_quality_flag = True
        if min_kmer_quality is not None:
            self.filter_kmer_quality_flag = True
        if max_genomes is not None:
            self.filter_max_genomes_flag = True

    def _fold_chunks(self, chunks: Iterable[Chunk], m, p, min_read_quality,
                     min_kmer_quality, max_genomes, store_reads: bool = False
                     ) -> Tuple[FoldCarry, int, List[StoreLists]]:
        """Align and fold every chunk into a fresh device carry; with
        ``store_reads`` also each chunk's mapping lists, on their way to
        the host (CUDA: pinned memory, non-blocking, complete once the
        carry has been fetched)."""
        ref = self.kmer_reference
        k = ref.index.k
        member = ref.set_member_device(self.device)
        use_qual = min_read_quality is not None or min_kmer_quality is not None
        mrq, has_mrq = min_read_quality or 0, min_read_quality is not None
        if k >= 1:
            probe_tab = ref.device_probe_tables(self.device)

            def batch_fn(codes, qual, lengths):
                return align_batch(
                    probe_tab, member, codes, qual, lengths,
                    m, p, mrq, min_kmer_quality or 0, max_genomes or 0,
                    k=k, has_mrq=has_mrq, has_mkq=min_kmer_quality is not None,
                    has_mg=max_genomes is not None)
        else:
            def batch_fn(codes, qual, lengths):
                # a read has no k-mer: no window to encode or probe
                return unmapped_batch(member.shape[1], qual, lengths, mrq,
                                      has_mrq=has_mrq)
        carry = init_fold_carry(member.shape[1], self.device,
                                start_batch=self._batch_no)
        n_batches = 0
        lists: List[StoreLists] = []
        for codes_p, qual, lengths, got in chunks:
            with phase("stage"):
                lengths_d = upload(lengths, self.device)
                codes_d = upload(codes_p, self.device)
                qual_d = upload(qual, self.device) if use_qual else None
            with phase("enqueue"):
                res = batch_fn(codes_d, qual_d, lengths_d)
                # zero-length rows are the tail padding of the final chunk
                # (the FASTQ grammar requires a nonempty sequence line)
                carry = _fold_agg(carry, aggregate_batch(res, lengths_d > 0))
            if store_reads:
                lists.append(StoreLists(*(
                    t.to("cpu", non_blocking=True)
                    for t in store_lists(res, int(got)))))
            n_batches += 1
        return carry, n_batches, lists

    def _finish_run(self, carry: FoldCarry, n_batches: int,
                    lists: List[StoreLists], ids: Optional[Sequence[str]]) -> None:
        """The run's one fetch of the carry (which also completes the
        lists' copies, and the device phases ``PROFILER.settle`` then
        reads), the read store, then the host totals: a duplicate
        read id raises before any total moves, as in the JAX package."""
        with phase("carry_fetch"):
            host = FoldCarry(*(t.cpu().numpy() for t in carry))
        # the fetch drained the stream: the batches' device phases are done
        PROFILER.settle()
        if lists:
            with phase("read_store"):
                self._store_lists(lists, ids)
        with phase("host_merge"):
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
        store_reads: bool = False,
    ) -> None:
        """Align a ``FASTAQStream``.  The native fill validates the input
        while it packs; a validation failure raises ``NativeParseError``
        and the caller re-reads the file through the regex engine for the
        reference's exact errors.

        ``store_reads=True`` (the align task) also keeps every read's
        mapping list; the ids come from one native pass over the input
        after the validation, and the store fills only then, so an
        invalid input never reaches it."""
        self._check_args(m, p, min_read_quality, min_kmer_quality, max_genomes)
        b = batch_size or device_routes(self.device).auto_batch(stream.est_records())
        use_qual = min_read_quality is not None or min_kmer_quality is not None
        stream.start_validation()

        # in lazy mode max_len is a first-record peek; a longer record
        # midway raises LmaxExceeded and the pass restarts at twice the
        # stride (rare: reads are near-uniform in length)
        lpad = _lpad(stream.max_len, self.kmer_reference.index.k)
        while True:
            try:
                carry, n_batches, lists = self._fold_chunks(
                    _prefetch_iter(stream.chunks_packed(b, lpad, use_qual)),
                    m, p, min_read_quality, min_kmer_quality, max_genomes,
                    store_reads)
                break
            except LmaxExceeded:
                lpad *= 2
        with phase("validate"):
            stream.finish_validation()  # NativeParseError discards the run
        ids = None
        if lists:
            with phase("read_store"):
                ids = native.fastq_ids(stream.raw_bytes(),
                                       sum(int(x.word.shape[0]) for x in lists))
            if ids is None:
                # the id walk disagreed with the validated stream (should
                # not happen): discard the run, the caller re-parses
                raise NativeParseError(native.STATUS_NON_ASCII, 0, 0)
        self._finish_run(carry, n_batches, lists, ids)

    def align_reads_from_container(
        self,
        reads_container: Iterable[SeqRecord],
        m: int = 1,
        p: int = 1,
        min_read_quality: Optional[int] = None,
        min_kmer_quality: Optional[int] = None,
        max_genomes: Optional[int] = None,
        batch_size: int = 1024,
        store_reads: bool = True,
        mesh: Optional[Mesh] = None,
    ) -> None:
        """Align parsed records (the regex-engine fallback route, and the
        mesh route) through ``align_packed_reads``."""
        if hasattr(reads_container, "to_read_batch"):
            batch = reads_container.to_read_batch()
        else:
            batch = pack_reads(list(reads_container))
        self.align_packed_reads(batch, m, p, min_read_quality, min_kmer_quality,
                                max_genomes, batch_size, store_reads, mesh)

    def align_packed_reads(
        self,
        batch: ReadBatch,
        m: int = 1,
        p: int = 1,
        min_read_quality: Optional[int] = None,
        min_kmer_quality: Optional[int] = None,
        max_genomes: Optional[int] = None,
        batch_size: int = 1024,
        store_reads: bool = True,
        mesh: Optional[Mesh] = None,
    ) -> None:
        """Align a packed ``ReadBatch`` on this alignment's device: packed
        on the host into the chunks the stream yields; the store's ids are
        the batch's own.

        ``mesh`` (``parallel``; needs ``store_reads=False``): each batch,
        rounded up to a multiple of the data axis, is sharded over it, the
        probe table replicated or, on a ``("data", "table")`` mesh at
        ``auto`` or ``sort``, the sort table range-partitioned over the
        table axis (``mesh_probe_tables``); the summary equals the
        single-device run's."""
        if mesh is not None and store_reads:
            raise ValueError("mesh-sharded alignment requires store_reads=False")
        self._check_args(m, p, min_read_quality, min_kmer_quality, max_genomes)
        n = batch.num_reads
        b = batch_size or device_routes(self.device).auto_batch(n)
        if mesh is not None:
            b = -(-b // mesh.shape["data"]) * mesh.shape["data"]
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

        gates = (m, p, min_read_quality, min_kmer_quality, max_genomes)
        if mesh is None:
            carry, n_batches, lists = self._fold_chunks(chunks(), *gates, store_reads)
        else:
            carry, n_batches = self._fold_mesh(chunks(), mesh, *gates)
            lists = []
        self._finish_run(carry, n_batches, lists, batch.ids)

    def mesh_probe_tables(self, mesh: Mesh) -> Tuple[Any, tuple]:
        """(the mesh's align step, its probe table on each device), placed
        once a mesh.  A ``("data", "table")`` mesh takes the sort table at
        ``auto`` and ``sort`` ($SHOTGUN_TPU_PROBE), whatever ``auto`` picks
        for one device: only the sort join range-partitions, so the table is
        cut where it lives (``KmerReference.sort_columns``) and each device
        receives its own key range.  On an
        explicit hash table, and on a data mesh, the reference's table is
        replicated and the mesh runs data parallel, as the JAX package runs
        every mesh."""
        ref = self.kmer_reference
        requested = os.environ.get(PROBE_ENV, "auto")
        split = "table" in mesh.shape and (
            requested == "auto" or ref.probe_method(requested) == "sort")
        key = (mesh.devices, tuple(mesh.shape.items()), split, requested)
        if key not in self._mesh_tables:
            if split:
                tabs = device_put_sharded_table(
                    mesh, shard_sorted_table(ref.sort_columns(), mesh.table))
            else:
                (tabs,) = replicate(mesh, ref.device_probe_tables(mesh.devices[0]))
            self._mesh_tables[key] = tabs
        step = align_aggregate_table_sharded if split else align_aggregate_sharded
        return step, self._mesh_tables[key]

    def _fold_mesh(self, chunks: Iterable[Chunk], mesh: Mesh, m, p, min_read_quality,
                   min_kmer_quality, max_genomes) -> Tuple[FoldCarry, int]:
        """Align every chunk over ``mesh`` and fold the merged results into
        a carry on its first device; the set membership is placed once a
        run, the tables once a mesh."""
        ref = self.kmer_reference
        k = ref.index.k
        dev = mesh.devices[0]
        use_qual = min_read_quality is not None or min_kmer_quality is not None
        (member,) = replicate(mesh, ref.set_member_device(dev))
        step, tabs = align_aggregate_sharded, None
        if k >= 1:
            step, tabs = self.mesh_probe_tables(mesh)
        carry = init_fold_carry(member[0].shape[1], dev, start_batch=self._batch_no)
        n_batches = 0
        for codes_p, qual, lengths, rows in chunks:
            shards = shard_read_arrays(mesh, codes_p, qual if use_qual else None, lengths,
                                       np.arange(lengths.shape[0]) < rows)
            agg = step(tabs, member, *shards, m, p, min_read_quality or 0,
                       min_kmer_quality or 0, max_genomes or 0, mesh=mesh, k=k,
                       has_mrq=min_read_quality is not None,
                       has_mkq=min_kmer_quality is not None,
                       has_mg=max_genomes is not None)
            carry = _fold_agg(carry, agg)
            n_batches += 1
        return carry, n_batches

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
        # first_key = row * (R + 2) + rank in the list; the JAX package's R
        # is its padded record axis, and .aln files carry its values: the
        # same order, re-encoded
        fk = fk // (r + 2) * (_jax_record_width(r) + 2) + fk % (r + 2)
        fresh = (fb < FOLD_INF) & (self._first_batch == _INF)
        self._first_batch[fresh] = fb[fresh]
        self._first_key[fresh] = fk[fresh]

    # -- read store (reference kmer.py:536-561) -------------------------------

    def _store_lists(self, lists: Sequence[StoreLists], ids: Sequence[str]) -> None:
        """Extend the read store by each batch's fetched lists, in input
        order.  MRQ-filtered reads are not stored.  A duplicate id raises
        ``AddingExistingRead`` at the first duplicate, with the reads
        before it stored (the reference's add_read, kmer.py:551-561)."""
        start = 0
        for word, counts, flat in lists:
            word = word.numpy()
            counts = counts.numpy()
            flat = flat.numpy()
            rows = word.shape[0]
            batch_ids = ids[start: start + rows]
            start += rows
            filtered = (word >> 2).astype(bool)
            mtype = word & 3
            kept_idx = np.nonzero(~filtered)[0]
            kept_ids = ([batch_ids[i] for i in kept_idx] if filtered.any()
                        else list(batch_ids))
            new_ids = set(kept_ids)
            if len(new_ids) != len(kept_ids) or not new_ids.isdisjoint(
                    self._seen_ids):
                # rare error path: per-read views only here (filtered rows
                # have empty lists, so splits line up with the rows)
                splits = np.split(flat, np.cumsum(counts)[:-1])
                for i, rid in zip(kept_idx, kept_ids):
                    if rid in self._seen_ids:
                        raise AddingExistingRead(
                            f"There already exists a read with identifier: {rid}")
                    self._seen_ids.add(rid)
                    self._read_ids.append(rid)
                    self._mtypes.append(int(mtype[i]))
                    self._list_flat.append(splits[i])
                    self._list_counts.append(int(counts[i]))
                raise AssertionError("duplicate detected by set check but "
                                     "not found in walk")
            self._seen_ids |= new_ids
            self._read_ids.extend(kept_ids)
            self._list_flat.append(flat)
            self._mtypes.extend(mtype[kept_idx].tolist())
            self._list_counts.extend(counts[kept_idx].tolist())

    def get_reads_by_mapping_type(self, mapping_type: ReadMappingType) -> List[str]:
        code = _CODE_FROM_MTYPE[mapping_type]
        return [rid for rid, c in zip(self._read_ids, self._mtypes) if c == code]

    # -- summary (reference kmer.py:622-657) ----------------------------------

    @phase("summary")
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

    def export_summary_to_json(self, json_file: str) -> None:
        with open(json_file, "w") as fh:
            json.dump(self.get_summary(), fh, indent=4)

    def __repr__(self) -> str:
        return json.dumps(self.get_summary(), indent=4)

    # -- persistence: the JAX package's .aln container (shotgun-tpu-aln v1) ---

    def save(self, align_file: str) -> None:
        """Write the ``.aln`` npz: the same members, dtypes and meta as the
        JAX package's ``save``, the ``.kdb`` bytes embedded."""
        buf = io.BytesIO()
        self.kmer_reference.save_to(buf)
        flat = (np.concatenate(self._list_flat) if self._list_flat
                else np.zeros(0, dtype=np.int64))
        offsets = np.concatenate(
            [[0], np.cumsum(np.asarray(self._list_counts, dtype=np.int64))])
        meta = {
            "format": "shotgun-tpu-aln",
            "version": 1,
            "flags": [
                self.filter_read_quality_flag,
                self.filter_kmer_quality_flag,
                self.filter_max_genomes_flag,
            ],
            "counters": [
                self._n_unique, self._n_ambiguous, self._n_unmapped,
                self.filtered_quality_reads, self.filtered_quality_kmers,
                self.filtered_hr_kmers, self._batch_no,
            ],
        }
        with open(align_file, "wb") as fh:
            np.savez(  # uncompressed, as the .kdb (reference.save_to)
                fh,
                meta=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
                read_ids=np.frombuffer(
                    "\n".join(self._read_ids).encode("utf-8"), dtype=np.uint8),
                mtypes=np.asarray(self._mtypes, dtype=np.int32),
                list_flat=flat,
                list_offsets=offsets,
                unique_by_rec=self._unique_by_rec,
                amb_by_rec=self._amb_by_rec,
                first_batch=self._first_batch,
                first_key=self._first_key,
                kdb=np.frombuffer(buf.getvalue(), dtype=np.uint8),
            )

    @classmethod
    def load(cls, align_file: str,
             device: Optional[Union[str, torch.device]] = None) -> "PseudoAlignment":
        """Read an ``.aln`` file of either package.  ``device`` (default
        ``resolve_device()``, decided before the file is read) is where
        further reads would be aligned; the summary and the store need
        none."""
        device = resolve_device(device)
        try:
            with np.load(align_file, allow_pickle=False) as data:
                meta = json.loads(bytes(data["meta"]).decode("utf-8"))
                if meta.get("format") != "shotgun-tpu-aln":
                    raise KDBFormatError("not a shotgun-tpu aln file")
                ref = KmerReference.load(io.BytesIO(bytes(data["kdb"])), device)
                out = cls(ref, device)
                ids_blob = bytes(data["read_ids"]).decode("utf-8")
                out._read_ids = ids_blob.split("\n") if ids_blob else []
                out._mtypes = data["mtypes"].tolist()
                flat = data["list_flat"]
                out._list_flat = [flat] if flat.size else []
                out._list_counts = np.diff(data["list_offsets"]).tolist()
                out._seen_ids = set(out._read_ids)
                out._unique_by_rec = data["unique_by_rec"]
                out._amb_by_rec = data["amb_by_rec"]
                out._first_batch = data["first_batch"]
                out._first_key = data["first_key"]
                (out._n_unique, out._n_ambiguous, out._n_unmapped,
                 out.filtered_quality_reads, out.filtered_quality_kmers,
                 out.filtered_hr_kmers, out._batch_no) = meta["counters"]
                (out.filter_read_quality_flag, out.filter_kmer_quality_flag,
                 out.filter_max_genomes_flag) = meta["flags"]
                return out
        except KDBFormatError:
            raise
        except Exception as exc:
            raise KDBFormatError(f"cannot read alignment file: {exc}") from exc
