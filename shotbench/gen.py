"""Seeded inputs of the benchmark: genomes, samples of reads with
abundances, substitutions and qualities, and their FASTA and FASTQ files.

The arithmetic of the port's ``utils/synth.py`` (uniform random
ancestors, strains as copies with every base substituted at a rate, a
substitution adding 1..3 mod 4, reads drawn from uniform positions),
extended with what a shotgun sample has and that module lacks: genome
abundances from a log-normal, and Illumina-like qualities.  Everything is
drawn on ``device`` (the card in a run) by ``torch.Generator`` streams
derived from ``--seed``, in chunks of a fixed size, so one seed gives the
same inputs on one kind of device.  Files are written from byte tensors
built whole, with fixed-width read ids: no Python loop over records.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

#: reads drawn, and FASTQ bytes built, per step
CHUNK = 1 << 18
ACGT = torch.tensor(list(b"ACGT"), dtype=torch.uint8)
NEWLINE = 10
FASTA_LINE = 80
#: digits of a read's number in its id
ID_DIGITS = 9


def stream_seed(seed: int, *stream: int) -> int:
    """A 64-bit seed for the named sub-stream of ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *stream])
    return int(ss.generate_state(1, np.uint64)[0])


def torch_gen(device: torch.device, seed: int, *stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *stream))
    return g


@dataclass
class Genomes:
    descriptions: List[str]
    codes: torch.Tensor      # uint8 [total bases] 0..3, on the device
    offsets: np.ndarray      # int64 [G + 1]

    @property
    def count(self) -> int:
        return len(self.descriptions)

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)


def make_genomes(cfg: dict, seed: int, device: torch.device) -> Genomes:
    """``cfg['species']`` random ancestors of ``cfg['genome_len']`` bases,
    each copied ``cfg['strains_per_species']`` times with every base
    substituted at ``cfg['strain_mutation_rate']`` (a single strain of a
    species is its ancestor); species-major order."""
    species, strains = cfg["species"], cfg["strains_per_species"]
    length, rate = cfg["genome_len"], cfg["strain_mutation_rate"]
    if species * strains != cfg["genomes"]:
        raise ValueError("genomes must equal species x strains_per_species")
    g = torch_gen(device, seed, 1)
    codes = torch.randint(0, 4, (species, length), generator=g, device=device,
                          dtype=torch.uint8)
    if strains > 1:
        codes = codes.repeat_interleave(strains, dim=0)
        for row in codes:  # one genome at a time bounds the draws' memory
            hit = torch.rand(length, generator=g, device=device) < rate
            shift = torch.randint(1, 4, (length,), generator=g, device=device,
                                  dtype=torch.uint8)
            row.copy_(torch.where(hit, (row + shift) % 4, row))
    n = species * strains
    descs = [f"genome_{i:03d}" for i in range(n)]
    offsets = np.arange(n + 1, dtype=np.int64) * length
    return Genomes(descs, codes.reshape(-1), offsets)


def read_counts(n_genomes: int, n_reads: int, mu: float, sigma: float,
                rng: np.random.Generator) -> np.ndarray:
    """Reads of each genome: shares of log-normal abundances, rounded by
    largest remainder so they sum to ``n_reads``."""
    share = rng.lognormal(mu, sigma, n_genomes)
    share /= share.sum()
    exact = share * n_reads
    counts = np.floor(exact).astype(np.int64)
    rest = n_reads - int(counts.sum())
    counts[np.argsort(-(exact - counts), kind="stable")[:rest]] += 1
    return counts


@dataclass
class Sample:
    codes: np.ndarray    # uint8 [N, L] 0..3
    qual: np.ndarray     # uint8 [N, L] raw quality bytes (Phred + offset)
    counts: np.ndarray   # int64 [G] reads drawn from each genome


def quality_profile(read_len: int, q: dict) -> torch.Tensor:
    """Phred score of each position: ``phred_start`` falling linearly to
    ``phred_end`` at the 3' end, rounded."""
    pos = torch.arange(read_len, dtype=torch.float64)
    slope = (q["phred_end"] - q["phred_start"]) / max(read_len - 1, 1)
    return torch.round(q["phred_start"] + slope * pos).to(torch.int32)


def make_sample(genomes: Genomes, cfg: dict, traffic: dict, seed: int,
                file_no: int, device: torch.device) -> Sample:
    """One sample of ``traffic['reads_per_sample']`` reads of
    ``cfg['read_len']`` bases, drawn from ``genomes`` at log-normal
    abundances, in random order, each base substituted at
    ``traffic['error_rate']``; qualities by ``traffic['quality']``."""
    n, length = traffic["reads_per_sample"], cfg["read_len"]
    ab, q = traffic["abundance"], traffic["quality"]
    rng = np.random.default_rng(stream_seed(seed, 2, file_no))
    counts = read_counts(genomes.count, n, ab["lognormal_mu"], ab["lognormal_sigma"], rng)
    g = torch_gen(device, seed, 3, file_no)
    gid = torch.repeat_interleave(torch.arange(genomes.count, device=device),
                                  torch.from_numpy(counts).to(device))
    gid = gid[torch.randperm(n, generator=g, device=device)]
    off = torch.from_numpy(genomes.offsets).to(device)
    span = torch.from_numpy(genomes.lengths() - length + 1).to(device)
    profile = quality_profile(length, q).to(device)
    iota = torch.arange(length, device=device)
    codes_out = np.empty((n, length), dtype=np.uint8)
    qual_out = np.empty((n, length), dtype=np.uint8)
    for a in range(0, n, CHUNK):
        gi = gid[a: a + CHUNK]
        m = gi.numel()
        start = (torch.rand(m, generator=g, device=device, dtype=torch.float64)
                 * span[gi]).to(torch.int64)
        codes = genomes.codes[(off[gi] + start)[:, None] + iota]
        hit = torch.rand((m, length), generator=g, device=device) < traffic["error_rate"]
        shift = torch.randint(1, 4, (m, length), generator=g, device=device,
                              dtype=torch.uint8)
        codes = torch.where(hit, (codes + shift) % 4, codes)
        low = torch.rand((m, length), generator=g, device=device) < q["low_share"]
        low_q = torch.randint(q["low_min"], q["low_max"] + 1, (m, length), generator=g,
                              device=device, dtype=torch.int32)
        qual = torch.where(low, low_q, profile) + q["offset"]
        codes_out[a: a + m] = codes.cpu().numpy()
        qual_out[a: a + m] = qual.to(torch.uint8).cpu().numpy()
    return Sample(codes_out, qual_out, counts)


def fastq_records(codes: torch.Tensor, qual: torch.Tensor, file_no: int,
                  first: int) -> torch.Tensor:
    """uint8 [n, record] FASTQ bytes of reads numbered from ``first``:
    ``@s<file>r<number>``, the bases, ``+``, the quality bytes."""
    n, length = codes.shape
    dev = codes.device
    head = torch.tensor(list(b"@s%03dr" % file_no), dtype=torch.uint8, device=dev)
    num = torch.arange(first, first + n, device=dev, dtype=torch.int64)[:, None]
    scale = 10 ** torch.arange(ID_DIGITS - 1, -1, -1, device=dev, dtype=torch.int64)
    digits = (num // scale % 10 + ord("0")).to(torch.uint8)

    def col(byte: int) -> torch.Tensor:
        return torch.full((n, 1), byte, dtype=torch.uint8, device=dev)

    return torch.cat([head.expand(n, -1), digits, col(NEWLINE),
                      ACGT.to(dev)[codes.long()], col(NEWLINE), col(ord("+")),
                      col(NEWLINE), qual, col(NEWLINE)], dim=1)


def write_fastq(path: str, sample: Sample, file_no: int, device: torch.device) -> int:
    """Write ``sample`` as FASTQ; returns the bytes written."""
    written = 0
    with open(path, "wb") as fh:
        for a in range(0, sample.codes.shape[0], CHUNK):
            rec = fastq_records(torch.from_numpy(sample.codes[a: a + CHUNK]).to(device),
                                torch.from_numpy(sample.qual[a: a + CHUNK]).to(device),
                                file_no, a)
            buf = rec.cpu().numpy()
            buf.tofile(fh)
            written += buf.size
        _settle(fh)
    return written


def write_fasta(path: str, genomes: Genomes) -> int:
    """Write ``genomes`` as FASTA, 80 bases a line; returns the bytes
    written."""
    acgt = ACGT.numpy()
    codes = genomes.codes.cpu().numpy()
    written = 0
    with open(path, "wb") as fh:
        for i, desc in enumerate(genomes.descriptions):
            seq = acgt[codes[genomes.offsets[i]: genomes.offsets[i + 1]]]
            full = seq.size // FASTA_LINE
            body = np.empty((full, FASTA_LINE + 1), dtype=np.uint8)
            body[:, :FASTA_LINE] = seq[: full * FASTA_LINE].reshape(full, FASTA_LINE)
            body[:, FASTA_LINE] = NEWLINE
            parts = [b">%s\n" % desc.encode(), body.tobytes()]
            if seq.size > full * FASTA_LINE:
                parts.append(seq[full * FASTA_LINE:].tobytes() + b"\n")
            for part in parts:
                fh.write(part)
                written += len(part)
        _settle(fh)
    return written


def _settle(fh) -> None:
    """Write the file through to the disk now, in set-up, so that its
    write-back does not land in a measured window."""
    fh.flush()
    os.fsync(fh.fileno())


