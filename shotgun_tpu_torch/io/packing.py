"""Host-side packing of parsed records into dense numpy arrays (the port's copy of
``shotgun_tpu/io/packing.py``).

This is the boundary between the string world (strict parsers) and the
numeric core (2-bit base codes, raw-``ord`` quality bytes).  Everything the
device touches is produced here as padded, statically-shaped arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence

import numpy as np

from shotgun_tpu_torch import constants
from shotgun_tpu_torch.io.records import SeqRecord


def encode_bases(seq: str) -> np.ndarray:
    """ASCII sequence -> uint8 base codes (A=0 C=1 G=2 T=3 N=4)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return constants.BASE_CODE_LUT[raw]


@dataclass
class GenomeArrays:
    """All genomes of a FASTA container, concatenated.

    ``descriptions`` keeps one entry per *record* in input order; duplicate
    descriptions remain distinct records, as in the reference where records
    hash by identity (reference records.py:74-99).
    """

    descriptions: List[str]
    codes: np.ndarray        # uint8 [total_bases] concatenated
    offsets: np.ndarray      # int64 [G+1]

    @property
    def num_records(self) -> int:
        return len(self.descriptions)

    def record_codes(self, i: int) -> np.ndarray:
        return self.codes[self.offsets[i]: self.offsets[i + 1]]

    def record_length(self, i: int) -> int:
        return int(self.offsets[i + 1] - self.offsets[i])


def pack_genomes(records: Iterable[SeqRecord]) -> GenomeArrays:
    descriptions: List[str] = []
    chunks: List[np.ndarray] = []
    lengths: List[int] = [0]
    for rec in records:
        descriptions.append(rec["description"])
        chunk = encode_bases(rec["genome"])
        chunks.append(chunk)
        lengths.append(chunk.size)
    codes = (np.concatenate(chunks) if chunks
             else np.zeros(0, dtype=np.uint8))
    offsets = np.cumsum(np.asarray(lengths, dtype=np.int64))
    return GenomeArrays(descriptions=descriptions, codes=codes, offsets=offsets)


@dataclass
class ReadBatch:
    """A batch of FASTQ reads padded to a common max length.

    ``qual`` holds the raw ASCII byte of each quality character -- quality
    semantics are the plain ``ord()`` mean with no PHRED offset
    (reference kmer.py:394-408).  Padding positions hold 0 in both arrays
    and are excluded by ``lengths``.
    """

    ids: List[str]
    codes: np.ndarray    # uint8 [N, Lmax]
    qual: np.ndarray     # uint8 [N, Lmax]
    lengths: np.ndarray  # int32 [N]

    @property
    def num_reads(self) -> int:
        return len(self.ids)

    @property
    def max_len(self) -> int:
        return int(self.codes.shape[1]) if self.num_reads else 0


def pack_reads(records: Sequence[SeqRecord], pad_to: int = 0) -> ReadBatch:
    ids = [rec.identifier for rec in records]
    lengths = np.asarray([len(rec["sequence"]) for rec in records], dtype=np.int32)
    lmax = max(int(lengths.max(initial=0)), pad_to, 1)
    n = len(records)
    codes = np.zeros((n, lmax), dtype=np.uint8)
    qual = np.zeros((n, lmax), dtype=np.uint8)
    for i, rec in enumerate(records):
        li = lengths[i]
        codes[i, :li] = encode_bases(rec["sequence"])
        qual[i, :li] = np.frombuffer(
            rec["quality_sequence"].encode("ascii"), dtype=np.uint8
        )
    return ReadBatch(ids=ids, codes=codes, qual=qual, lengths=lengths)
