"""File-level I/O: extension gating, transparent gzip, parser dispatch (the port's copy of
``shotgun_tpu/io/data_file.py``).

Mirrors the reference's DataFile layer (reference: src/data_file.py:39-158):
``FASTAFile`` accepts ``.fa``/``.fa.gz``, ``FASTAQFile`` accepts
``.fq``/``.fq.gz``; the whole file is read (gzip-transparent) and handed to
the strict parser; ``NoRecordsInData`` is rewrapped into
``NoRecordsInDataFile`` with the file path in the message.

Parsing prefers the native C++ scanner (io/csrc/shotgun_io.cpp, ~50x the
regex engine) on ASCII input; any validation failure or non-ASCII content
falls back to the Python regex engine, which raises the reference's exact
exception types and messages -- so error behavior is identical by
construction.
"""

from __future__ import annotations

import gzip
import os
from typing import FrozenSet, Optional

from shotgun_tpu_torch.io import native
from shotgun_tpu_torch.io.records import (
    FASTAParser,
    FASTQParser,
    NoRecordsInData,
    SchemaParser,
)


class InvalidExtensionError(Exception):
    def __init__(self, message: str = "") -> None:
        super().__init__(message)


class NoRecordsInDataFile(Exception):
    def __init__(self, message: str = "") -> None:
        super().__init__(message)


class DataFile:
    """Base class: validates the extension, loads, parses."""

    EXTENSIONS: FrozenSet[str] = frozenset()

    def __init__(self, file_path: str) -> None:
        if not self.EXTENSIONS:
            raise NotImplementedError("EXTENSIONS must be defined.")
        if not any(file_path.endswith(ext) for ext in self.EXTENSIONS):
            raise InvalidExtensionError(
                f"Invalid file extension. Expected one of {set(self.EXTENSIONS)}, got {file_path}"
            )
        raw = self._read_bytes(file_path)
        container = self._parse_native(raw)
        if container is None:
            container = self._make_parser()
            try:
                container.parse_records(raw.decode("utf-8"))
            except NoRecordsInData:
                raise NoRecordsInDataFile(
                    f"No valid records found in file: {file_path}"
                )
        self.container: SchemaParser = container

    def _make_parser(self) -> SchemaParser:
        raise NotImplementedError("This method must be implemented in subclasses.")

    def _parse_native(self, raw: bytes) -> Optional[SchemaParser]:
        """Native happy path; None -> use the regex engine (which also
        reproduces the exact error for invalid input)."""
        return None

    @staticmethod
    def _read_bytes(file_path: str) -> bytes:
        if file_path.endswith(".gz"):
            with gzip.open(file_path, "rb") as fh:
                return fh.read()
        with open(file_path, "rb") as fh:
            return fh.read()

    def dump(self, output_file: str) -> None:
        """Pickle the parsed container (reference data_file.py:92-98)."""
        import pickle

        with open(output_file, "wb") as fh:
            pickle.dump(self.container, fh)


class FASTAFile(DataFile):
    EXTENSIONS = frozenset({".fa", ".fa.gz"})

    def _make_parser(self) -> FASTAParser:
        return FASTAParser()

    def _parse_native(self, raw: bytes) -> Optional[FASTAParser]:
        try:
            res = native.fasta_parse(raw)
        except native.NativeParseError:
            return None
        if res is None:
            return None
        return FASTAParser.from_native(*res)


class FASTAQFile(DataFile):
    EXTENSIONS = frozenset({".fq", ".fq.gz"})

    def _make_parser(self) -> FASTQParser:
        return FASTQParser()

    def _parse_native(self, raw: bytes) -> Optional[FASTQParser]:
        try:
            res = native.fastq_parse(raw)
        except native.NativeParseError:
            return None
        if res is None:
            return None
        return FASTQParser.from_native(*res)


class FASTAQStream:
    """Streaming FASTQ source: validate once, fill record chunks on demand.

    The pipeline-parallel input path (SURVEY.md §2.2 PP row): the native
    scanner validates the whole file up front (same duplicate-id /
    unparsed-data / length-mismatch contracts as the full parse), then
    ``chunks`` fills packed [chunk, lmax] arrays one batch at a time so the
    caller can overlap host parse/pack with async device dispatch.  Record
    ids are never materialized as Python strings -- per-record ``.decode``
    calls are the dominant cost of the full parse at bench scale.

    Use ``open_fastq_stream``; anything the native fast path cannot serve
    (missing lib, non-ASCII input, any validation failure) returns None so
    the caller falls back to ``FASTAQFile``, whose regex engine reproduces
    the reference's exact error types and messages.
    """

    EXTENSIONS = FASTAQFile.EXTENSIONS

    def __init__(self, file_path: str, lazy: bool = False) -> None:
        if not any(file_path.endswith(ext) for ext in self.EXTENSIONS):
            raise InvalidExtensionError(
                f"Invalid file extension. Expected one of {set(self.EXTENSIONS)}, got {file_path}"
            )
        raw = DataFile._read_bytes(file_path)  # gzip.BadGzipFile propagates
        self._raw = raw
        self._scan_thread = None
        self._scan_result = None
        self._vfill = False
        if lazy:
            # lazy mode: until validation completes, max_len is a PEEK at
            # the first record and num_records is unknown.  Default: the
            # VALIDATING native fill (chunks_vpacked) enforces the
            # whole-input contract inside the fill pass itself, on
            # native.fill_threads() threads;
            # SHOTGUN_TPU_VFILL=0 restores the overrun-safe plain fill
            # with the validation scan on a worker thread.  Either way a
            # validation failure discards the run (the caller falls back
            # to the regex engine for exact errors).
            if not native.available():
                raise native.NativeParseError(native.STATUS_NON_ASCII, 0, 0)
            self._vfill = os.environ.get("SHOTGUN_TPU_VFILL", "1") == "1"
            self.num_records: Optional[int] = None
            self.max_len: int = self._peek_first_len(raw)
            return
        info = native.fastq_scan(raw)  # NativeParseError propagates
        if info is None:
            raise native.NativeParseError(native.STATUS_NON_ASCII, 0, 0)
        self.num_records = info.n_records
        self.max_len = info.max_len

    @staticmethod
    def _peek_first_len(raw: bytes) -> int:
        """Length of the first record's sequence line (0 if malformed) --
        the lazy-mode initial stride guess; longer records retry."""
        i1 = raw.find(b"\n")
        if i1 < 0:
            return 0
        i2 = raw.find(b"\n", i1 + 1)
        end = i2 if i2 >= 0 else len(raw)
        if end > i1 + 1 and raw[end - 1: end] == b"\r":
            end -= 1
        return max(end - i1 - 1, 0)

    def raw_bytes(self) -> bytes:
        """The full input buffer (the streamed align task extracts ids
        from it in one native side pass after validation)."""
        return self._raw

    def start_validation(self) -> None:
        """Kick off the whole-input native scan on a worker thread (the
        ctypes call releases the GIL, so it overlaps the fill loop).
        No-op under the validating fill: the fill pass itself enforces
        the contract and raises during iteration."""
        if (self._vfill or self._scan_thread is not None
                or self.num_records is not None):
            return
        import threading

        def run():
            try:
                self._scan_result = native.fastq_scan(self._raw)
            except native.NativeParseError as exc:
                self._scan_result = exc

        self._scan_thread = threading.Thread(target=run, daemon=True)
        self._scan_thread.start()

    def finish_validation(self) -> None:
        """Join the scan; raise NativeParseError if the input is invalid
        (callers discard the streamed results and fall back)."""
        if self._scan_thread is not None:
            self._scan_thread.join()
            self._scan_thread = None
            res = self._scan_result
            if isinstance(res, native.NativeParseError):
                raise res
            if res is None:
                raise native.NativeParseError(native.STATUS_NON_ASCII, 0, 0)
            self.num_records = res.n_records
            self.max_len = res.max_len

    def est_records(self) -> int:
        """Record-count estimate for pipeline sizing: exact after
        validation; before it, a byte-budget guess from the first
        record's line length (a FASTQ record is ~2*L sequence/quality
        bytes plus header/separator overhead)."""
        if self.num_records is not None:
            return self.num_records
        per_record = 2 * max(self.max_len, 1) + 36
        return max(len(self._raw) // per_record, 1)

    def chunks(self, chunk_records: int, lmax: int):
        """Yield (codes, qual, lengths, n_filled) with row stride ``lmax``
        (must be >= ``self.max_len``); fresh zeroed arrays per chunk."""
        return native.fastq_stream_chunks(self._raw, chunk_records, lmax)

    def chunks_packed(self, chunk_records: int, lmax: int, with_qual: bool):
        """Yield (codes_2bit [C, lmax/4], qual-or-dummy, lengths, n_filled):
        the transfer-diet form -- codes arrive device-unpackable 2-bit
        packed straight from the native fill, and the quality plane is
        only materialized when a quality gate will consume it.  Under the
        validating fill (lazy default) the generator also enforces the
        whole-input contract, raising NativeParseError mid-iteration on
        invalid input."""
        if self._vfill:
            return native.fastq_stream_chunks_vpacked(
                self._raw, chunk_records, lmax, with_qual)
        return native.fastq_stream_chunks_packed(
            self._raw, chunk_records, lmax, with_qual)


def open_fastq_stream(
    file_path: str, lazy: bool = False
) -> Optional[FASTAQStream]:
    """FASTAQStream for the file, or None when the native fast path cannot
    serve it (the caller should construct FASTAQFile instead -- including
    for invalid inputs, where the regex engine raises the reference's exact
    errors).  InvalidExtensionError and gzip.BadGzipFile propagate.

    ``lazy``: skip the up-front scan; validation overlaps the align loop
    (a validation failure then surfaces as NativeParseError from
    ``finish_validation`` mid-run, and the caller falls back)."""
    try:
        return FASTAQStream(file_path, lazy=lazy)
    except native.NativeParseError:
        return None
