"""Synthetic workloads for the port's smoke run, profiling tool and tests
(counterpart of ``shotgun_tpu/utils/synth.py``, whose generators
``synth_genomes``, ``synth_reads``, ``to_fasta`` and ``to_fastq`` are
copied here and give the same output from the same generator state).

Random genomes from a ``numpy.random.Generator``, reads sampled from
them with the genome each came from (the known truth of a dumpalign
run), and FASTA/FASTQ files for runs through the CLI.  Two knobs move
the workload off the no-overlap, error-free best case: ``strains`` makes
the genomes mutated copies of a few ancestors, so they share most of
their k-mers, and ``error_rate`` puts substitutions into the reads.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from shotgun_tpu_torch.io.packing import GenomeArrays, ReadBatch

__all__ = ["GenomeArrays", "Workload", "make_genomes", "sample_reads",
           "strain_panel", "strain_reads", "synth_genomes", "synth_reads",
           "to_fasta", "to_fastq", "write_fastq", "write_workload"]

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

#: the strain panel of ``chip_smoke.py`` and the benchmarks: STRAIN_GENOMES
#: genomes, round-robin copies of STRAIN_ANCESTORS random ancestors of
#: STRAIN_LEN bases with every base substituted at MUTATION_RATE; its reads
#: are READ_LEN bases with substitutions at ERROR_RATE
STRAIN_GENOMES = 32
STRAIN_ANCESTORS = 8
STRAIN_LEN = 200_000
MUTATION_RATE = 0.01
READ_LEN = 150
ERROR_RATE = 0.005


def synth_genomes(rng: np.random.Generator, n_genomes: int, length: int
                  ) -> GenomeArrays:
    """``n_genomes`` uniform random genomes of ``length`` bases."""
    codes = rng.integers(0, 4, size=n_genomes * length, dtype=np.uint8)
    offsets = np.arange(n_genomes + 1, dtype=np.int64) * length
    descriptions = [f"genome_{i}" for i in range(n_genomes)]
    return GenomeArrays(descriptions=descriptions, codes=codes, offsets=offsets)


def synth_reads(rng: np.random.Generator, genomes: GenomeArrays, n_reads: int,
                read_len: int, quality_char: str = "I") -> ReadBatch:
    """Error-free reads sampled uniformly from equal-length genomes."""
    length = genomes.record_length(0)
    gi = rng.integers(0, genomes.num_records, size=n_reads)
    start = rng.integers(0, length - read_len + 1, size=n_reads)
    idx = (genomes.offsets[gi] + start)[:, None] + np.arange(read_len, dtype=np.int64)[None, :]
    codes = genomes.codes[idx]
    qual = np.full((n_reads, read_len), ord(quality_char), dtype=np.uint8)
    lengths = np.full(n_reads, read_len, dtype=np.int32)
    ids = [f"read_{i}" for i in range(n_reads)]
    return ReadBatch(ids=ids, codes=codes, qual=qual, lengths=lengths)


def to_fasta(genomes: GenomeArrays) -> str:
    """FASTA text, 80 bases a line."""
    lines: List[str] = []
    for i, desc in enumerate(genomes.descriptions):
        lines.append(f">{desc}")
        seq = _BASES[genomes.record_codes(i) % 4].tobytes().decode("ascii")
        for j in range(0, len(seq), 80):
            lines.append(seq[j: j + 80])
    return "\n".join(lines) + "\n"


def to_fastq(reads: ReadBatch) -> str:
    """FASTQ text of a ``ReadBatch``."""
    lines: List[str] = []
    for i, rid in enumerate(reads.ids):
        li = int(reads.lengths[i])
        seq = _BASES[reads.codes[i, :li] % 4].tobytes().decode("ascii")
        qual = reads.qual[i, :li].tobytes().decode("ascii")
        lines += [f"@{rid}", seq, "+", qual]
    return "\n".join(lines) + "\n"


class Workload(NamedTuple):
    genomes: GenomeArrays
    codes: np.ndarray      # [N, read_len] uint8 base codes 0..3
    genome_of: np.ndarray  # [N] int64 genome each read was sampled from


def make_genomes(rng: np.random.Generator, n_genomes: int, length: int,
                 strains: int = 0, mutation_rate: float = 0.0) -> GenomeArrays:
    """``n_genomes`` random genomes of ``length`` bases.  With
    ``strains > 0`` they are ``strains`` random ancestors, each copied
    round-robin with every base substituted at ``mutation_rate``."""
    if strains <= 0:
        return synth_genomes(rng, n_genomes, length)
    ancestors = rng.integers(0, 4, size=(strains, length), dtype=np.uint8)
    codes = ancestors[np.arange(n_genomes) % strains]
    hit = rng.random(codes.shape, dtype=np.float32) < mutation_rate
    # a substitution always changes the base: add 1..3 mod 4
    shift = rng.integers(1, 4, size=int(hit.sum()), dtype=np.uint8)
    codes[hit] = (codes[hit] + shift) % 4
    offsets = np.arange(n_genomes + 1, dtype=np.int64) * length
    return GenomeArrays(descriptions=[f"genome_{i}" for i in range(n_genomes)],
                        codes=codes.reshape(-1), offsets=offsets)


def sample_reads(rng: np.random.Generator, genomes: GenomeArrays,
                 n_reads: int, read_len: int,
                 error_rate: float = 0.0) -> Workload:
    """Reads drawn uniformly from equal-length genomes, each base
    substituted at ``error_rate``."""
    length = genomes.record_length(0)
    gi = rng.integers(0, genomes.num_records, size=n_reads)
    start = rng.integers(0, length - read_len + 1, size=n_reads)
    idx = (genomes.offsets[gi] + start)[:, None] + np.arange(read_len)[None, :]
    codes = genomes.codes[idx]
    if error_rate > 0:
        hit = rng.random(codes.shape, dtype=np.float32) < error_rate
        shift = rng.integers(1, 4, size=int(hit.sum()), dtype=np.uint8)
        codes[hit] = (codes[hit] + shift) % 4
    return Workload(genomes, codes, gi)


def strain_panel(rng: np.random.Generator, length: int = STRAIN_LEN) -> GenomeArrays:
    """The strain panel's genomes (``length`` bases each)."""
    return make_genomes(rng, STRAIN_GENOMES, length, STRAIN_ANCESTORS, MUTATION_RATE)


def strain_reads(rng: np.random.Generator, genomes: GenomeArrays, n_reads: int
                 ) -> Workload:
    """``n_reads`` reads of the strain panel ``genomes``."""
    return sample_reads(rng, genomes, n_reads, READ_LEN, ERROR_RATE)


def write_fastq(path: str, codes: np.ndarray, qual: Optional[np.ndarray] = None) -> None:
    """One FASTQ record per row of ``codes``, with the raw quality bytes of
    that row of ``qual`` ([N, L] uint8), or every base at quality 'I'."""
    n, length = codes.shape
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    all_i = b"I" * length
    with open(path, "wb") as fh:
        for i in range(n):
            q = all_i if qual is None else qual[i].tobytes()
            fh.write(b"@read_%d\n%s\n+\n%s\n" % (i, seq[i].tobytes(), q))


def write_workload(work: Workload, fasta: str, fastq: str) -> None:
    """The genomes as FASTA and the reads as FASTQ."""
    with open(fasta, "w") as fh:
        fh.write(to_fasta(work.genomes))
    write_fastq(fastq, work.codes)
