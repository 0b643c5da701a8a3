"""Synthetic workloads for the port's smoke run and profiling tool
(counterpart of ``shotgun_tpu/utils/synth.py``, whose jax-free genome
generator it re-exports).

Random genomes from a ``numpy.random.Generator``, reads sampled from
them with the genome each came from (the known truth of a dumpalign
run), and FASTA/FASTQ files for runs through the CLI.  Two knobs move
the workload off the no-overlap, error-free best case: ``strains`` makes
the genomes mutated copies of a few ancestors, so they share most of
their k-mers, and ``error_rate`` puts substitutions into the reads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from shotgun_tpu.io.packing import GenomeArrays
from shotgun_tpu.utils.synth import synth_genomes, to_fasta

__all__ = ["GenomeArrays", "Workload", "make_genomes", "sample_reads",
           "synth_genomes", "to_fasta", "write_fastq", "write_workload"]


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


def write_fastq(path: str, codes: np.ndarray) -> None:
    """One FASTQ record per row of ``codes``, every base at quality 'I'."""
    n, length = codes.shape
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    qual = b"I" * length
    with open(path, "wb") as fh:
        for i in range(n):
            fh.write(b"@read_%d\n%s\n+\n%s\n" % (i, seq[i].tobytes(), qual))


def write_workload(work: Workload, fasta: str, fastq: str) -> None:
    """The genomes as FASTA and the reads as FASTQ."""
    with open(fasta, "w") as fh:
        fh.write(to_fasta(work.genomes))
    write_fastq(fastq, work.codes)
