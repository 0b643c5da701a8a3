"""Strict, schema-driven FASTA/FASTQ record parsing (the port's copy of
``shotgun_tpu/io/records.py``).

This layer replicates the *observable grammar* of the reference parser
(reference: src/records.py:122-302): each container class declares an ordered
tuple of field specs, a single multi-line regular expression is derived from
them and run over the whole input, and any non-whitespace character outside a
match is a hard error.  Unlike the reference, unparsed-data detection runs on
span gaps (O(#gap chars) on the error path, O(#records) otherwise) instead of
materializing a per-character index set, which makes parsing throughput
C-bound rather than Python-bound.

Exact error contracts carried over from the reference:
  * ``NoRecordsInData``      -- zero valid records        (records.py:178-179)
  * ``DuplicateRecordError`` -- duplicate unique index     (records.py:195-198)
  * ``UnparsedDataError``    -- stray non-whitespace data  (records.py:180-183)
  * ``InvalidRecordData``    -- FASTQ seq/quality length mismatch
                                                          (records.py:290-302)
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from shotgun_tpu_torch import constants

#: Lookahead that ends a record at the next record header or end of input
#: (reference records.py:14).
_NEXT_HEADER_OR_EOF = r"(?=(?=\r?\n{header})|(?=(?:\r?\n)?\Z))"
_UNPARSED_SNIPPET_LEN = 20


# ---------------------------------------------------------------------------
# exceptions
# ---------------------------------------------------------------------------

class NoRecordsInData(Exception):
    def __init__(self, message: str = "No valid records found in the data.") -> None:
        super().__init__(message)


class InvalidRecordData(Exception):
    def __init__(self, message: str = "") -> None:
        super().__init__(message)


class DuplicateRecordError(Exception):
    def __init__(self, message: str = "Duplicate records found for the unique index.") -> None:
        super().__init__(message)


class UnparsedDataError(Exception):
    def __init__(self, message: str = "Unparsed data found in the input.") -> None:
        super().__init__(message)


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FieldSpec:
    """One field of a record grammar.

    ``legal_chars`` / ``strip_chars`` are regex character-class snippets; a
    field matches ``(?:[legal_chars strip_chars])+?`` lazily (``*?`` when
    ``required`` is False), then ``strip_chars`` are deleted and the result
    is ``str.strip()``-ed, mirroring reference records.py:141-160,185-199.
    """

    name: str
    header: str
    required: bool
    legal_chars: str
    strip_chars: str = ""
    unique: bool = False


class SeqRecord:
    """A parsed record: named fields in declaration order.

    ``identifier`` is the first field's data (reference records.py:86).
    Instances hash by identity, like the reference's ``Record``.
    """

    __slots__ = ("identifier", "_fields")

    def __init__(self, fields: Sequence[Tuple[str, str]]) -> None:
        if not fields:
            raise InvalidRecordData("The data given to construct record has no sections.")
        self._fields: Dict[str, str] = {}
        for name, data in fields:
            if name in self._fields:
                raise InvalidRecordData(
                    f"Section header: {name} has appeared twice in the given data."
                )
            self._fields[name] = data
        self.identifier: str = fields[0][1]

    def __getitem__(self, key: str) -> str:
        return self._fields[key]

    def __str__(self) -> str:
        return "\n".join(f"{k}: {v}" for k, v in self._fields.items())

    __repr__ = __str__


class SchemaParser:
    """Generic whole-input record parser driven by a tuple of FieldSpecs.

    Subclasses set ``FIELD_SPECS``.  The derived regex and the accept/reject
    semantics match the reference's RecordContainer engine exactly.
    """

    FIELD_SPECS: Tuple[FieldSpec, ...] = ()

    def __init__(self) -> None:
        if not self.FIELD_SPECS:
            raise NotImplementedError("FIELD_SPECS must be defined.")
        self._pattern: str = self._build_pattern()
        self._regex = re.compile(self._pattern, flags=re.MULTILINE)
        self._records: List[SeqRecord] = []
        self._seen_unique: set = set()

    # -- grammar ------------------------------------------------------------

    def _build_pattern(self) -> str:
        parts: List[str] = []
        for i, spec in enumerate(self.FIELD_SPECS):
            if i == 0:
                parts.append("^" + re.escape(spec.header))
            else:
                parts.append(r"\r?\n" + re.escape(spec.header))
            quant = "+?" if spec.required else "*?"
            parts.append(f"((?:[{spec.legal_chars}{spec.strip_chars}]){quant})")
        first_header = re.escape(self.FIELD_SPECS[0].header)
        parts.append(_NEXT_HEADER_OR_EOF.format(header=first_header))
        return "".join(parts)

    @property
    def pattern(self) -> str:
        return self._pattern

    # -- parsing ------------------------------------------------------------

    def parse_records(self, data: str) -> None:
        spans: List[Tuple[int, int]] = []
        for match in self._regex.finditer(data):
            if not any(match.groups()):
                continue
            spans.append(match.span())
            self._accept_match(match.groups())
        if not self._records:
            raise NoRecordsInData
        self._check_unparsed(data, spans)

    def _accept_match(self, groups: Tuple[Optional[str], ...]) -> None:
        fields: List[Tuple[str, str]] = []
        for spec, raw in zip(self.FIELD_SPECS, groups):
            cleaned = raw or ""
            if spec.strip_chars:
                cleaned = re.sub(spec.strip_chars, "", cleaned)
            cleaned = cleaned.strip()
            fields.append((spec.name, cleaned))
            if spec.unique:
                if cleaned in self._seen_unique:
                    raise DuplicateRecordError(
                        f"Duplicate record found with unique index: {cleaned}"
                    )
                self._seen_unique.add(cleaned)
        self._records.append(SeqRecord(fields))

    def _check_unparsed(self, data: str, spans: List[Tuple[int, int]]) -> None:
        """Reject any non-whitespace character not covered by a match.

        Matches are yielded in input order and never overlap, so it is
        enough to scan the gaps between consecutive spans.
        """
        cursor = 0
        for start, end in spans:
            self._scan_gap(data, cursor, start)
            cursor = max(cursor, end)
        self._scan_gap(data, cursor, len(data))

    @staticmethod
    def _scan_gap(data: str, lo: int, hi: int) -> None:
        for i in range(lo, hi):
            if data[i].strip():
                snippet = data[i: i + _UNPARSED_SNIPPET_LEN]
                raise UnparsedDataError(
                    f"Unparsed data found at index {i}: {snippet}..."
                )

    # -- access -------------------------------------------------------------

    def _ensure_records(self) -> None:
        """Materialize SeqRecords when backed by native arrays (no-op for
        the regex path)."""

    def __iter__(self) -> Iterator[SeqRecord]:
        self._ensure_records()
        return iter(self._records)

    def __len__(self) -> int:
        self._ensure_records()
        return len(self._records)

    @property
    def records(self) -> List[SeqRecord]:
        self._ensure_records()
        return self._records

    @property
    def num_records(self) -> int:
        native = getattr(self, "_native", None)
        if native is not None and not self._records:
            return self._native_num_records()
        return len(self._records)

    def _native_num_records(self) -> int:
        """Record count from the native-array backing, without
        materializing SeqRecords.  Subclasses with a ``from_native``
        constructor must override (the tuple layouts differ)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# concrete grammars
# ---------------------------------------------------------------------------

class FASTAParser(SchemaParser):
    """FASTA: ``>description`` then a multi-line ACGTN sequence
    (reference records.py:212-239; description is NOT a unique index)."""

    FIELD_SPECS = (
        FieldSpec(
            name="description",
            header=">",
            required=True,
            legal_chars=r"\S\t ",
        ),
        FieldSpec(
            name="genome",
            header="",
            required=True,
            legal_chars=constants.NUCLEOTIDES,
            strip_chars=r"\s",
        ),
    )

    _native: Optional[tuple] = None  # (codes, offsets, descriptions)

    @classmethod
    def from_native(cls, codes, offsets, descriptions) -> "FASTAParser":
        self = cls()
        self._native = (codes, offsets, descriptions)
        return self

    def _native_num_records(self) -> int:
        return len(self._native[2])  # descriptions

    def _ensure_records(self) -> None:
        if self._native is None or self._records:
            return
        from shotgun_tpu_torch import constants as C
        codes, offsets, descriptions = self._native
        bases = C.CODE_TO_BASE[codes % 5]
        for i, desc in enumerate(descriptions):
            seq = bases[offsets[i]: offsets[i + 1]].tobytes().decode("ascii")
            self._records.append(
                SeqRecord([("description", desc), ("genome", seq)])
            )

    def to_genome_arrays(self):
        """Packed arrays without a string round-trip when native-parsed."""
        from shotgun_tpu_torch.io.packing import GenomeArrays, pack_genomes
        if self._native is not None:
            codes, offsets, descriptions = self._native
            return GenomeArrays(
                descriptions=list(descriptions),
                codes=codes,
                offsets=offsets,
            )
        return pack_genomes(self.records)


class FASTQParser(SchemaParser):
    """FASTQ: 4 single-line fields; N is illegal in read sequences, the
    ``+`` line may only contain literal dots, identifiers are unique, and
    sequence/quality lengths must agree (reference records.py:245-302)."""

    FIELD_SPECS = (
        FieldSpec(
            name="identifier",
            header="@",
            required=True,
            legal_chars=r"\S\t ",
            unique=True,
        ),
        FieldSpec(
            name="sequence",
            header="",
            required=True,
            legal_chars=re.escape(constants.REAL_NUCLEOTIDES),
        ),
        FieldSpec(
            name="space",
            header="+",
            required=False,
            legal_chars=".",
        ),
        FieldSpec(
            name="quality_sequence",
            header="",
            required=True,
            legal_chars=re.escape(constants.PHRED33_CHARS),
        ),
    )

    def parse_records(self, data: str) -> None:
        super().parse_records(data)
        for i, record in enumerate(self):
            ns, nq = len(record["sequence"]), len(record["quality_sequence"])
            if ns != nq:
                raise InvalidRecordData(
                    f"Mismatch in record {i + 1} between nucleotide length: {ns} "
                    f"and PHRED section lengths: {nq}"
                )

    _native: Optional[tuple] = None  # (codes, qual, lengths, ids, space_len)

    @classmethod
    def from_native(cls, codes, qual, lengths, ids, space_len) -> "FASTQParser":
        self = cls()
        self._native = (codes, qual, lengths, ids, space_len)
        return self

    def _native_num_records(self) -> int:
        return len(self._native[3])  # ids

    def _ensure_records(self) -> None:
        if self._native is None or self._records:
            return
        from shotgun_tpu_torch import constants as C
        codes, qual, lengths, ids, space_len = self._native
        bases = C.CODE_TO_BASE[codes % 5]
        for i, rid in enumerate(ids):
            li = int(lengths[i])
            seq = bases[i, :li].tobytes().decode("ascii")
            q = qual[i, :li].tobytes().decode("ascii")
            self._records.append(SeqRecord([
                ("identifier", rid),
                ("sequence", seq),
                ("space", "." * int(space_len[i])),
                ("quality_sequence", q),
            ]))

    def to_read_batch(self):
        """Packed ReadBatch without a string round-trip when native-parsed."""
        from shotgun_tpu_torch.io.packing import ReadBatch, pack_reads
        if self._native is not None:
            codes, qual, lengths, ids, _ = self._native
            return ReadBatch(ids=list(ids), codes=codes, qual=qual,
                             lengths=lengths)
        return pack_reads(self.records)


# Aliases matching the reference's public container names so users of the
# reference find the same API surface (reference records.py:212,245).
FASTARecordContainer = FASTAParser
FASTAQRecordContainer = FASTQParser
