"""Command-line interface of the port (counterpart of
``shotgun_tpu/cli.py``): ``python -m shotgun_tpu_torch``.

Same flag surface, validation order, defaulting quirks and error strings
as the JAX package's CLI, which replicates the reference CLI.  Ported:
``-t dumpalign`` with ``-r db.kdb --reads`` or ``-g -k --reads``.  The
``-g`` route builds the database on the device for genomes of 4-64 Mbp,
as the JAX package's does (``create_reference``), and on the host
otherwise.  The other tasks, and ``dumpalign -a``, exit non-zero with
"not yet ported".

The device comes from ``$SHOTGUN_TPU_TORCH_DEVICE`` (default ``cuda``;
asking for CUDA without it is an error, never a silent CPU run).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
from typing import List, Optional, Tuple

import torch

from shotgun_tpu.constants import (
    DEFAULT_AMBIGUOUS_THRESHOLD,
    DEFAULT_SIMILARITY_THRESHOLD,
    DEFAULT_UNIQUE_THRESHOLD,
)
from shotgun_tpu.errors import UserInputError
from shotgun_tpu.io.data_file import (
    FASTAFile,
    FASTAQFile,
    InvalidExtensionError,
    NoRecordsInDataFile,
    open_fastq_stream,
)
from shotgun_tpu.io.native import NativeParseError
from shotgun_tpu.io.packing import pack_genomes
from shotgun_tpu_torch.aligner import PseudoAlignment
from shotgun_tpu_torch.reference import PROBE_ENV, KDBFormatError, KmerReference
from shotgun_tpu_torch.utils.device import resolve_device
from shotgun_tpu_torch.utils.profiling import PROFILER, phase

#: 0 = auto: aligner._auto_batch picks by input size
DEFAULT_BATCH_SIZE = 0
#: the device build's genome-size window in bases (the JAX package's,
#: sized on a TPU); the environment variables below override it
DEVICE_BUILD_MIN = 4_000_000
DEVICE_BUILD_MAX = 64_000_000


def validate_file_readable(filepath: str, description: str) -> None:
    if not os.path.isfile(filepath):
        sys.exit(f"Error: {description} file '{filepath}' does not exist or is not a file.")
    if not os.access(filepath, os.R_OK):
        sys.exit(f"Error: {description} file '{filepath}' is not readable.")


def parse_arguments(args: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="shotgun-tpu-torch")
    parser.add_argument("-t", "--task", required=True, help="Task to execute")
    parser.add_argument("-g", "--genomefile", help="Genome FASTA file (multiple records)")
    parser.add_argument("-k", "--kmer-size", type=int, help="Length of k-mers")
    parser.add_argument("-r", "--referencefile", help="KDB file (input/output)")
    parser.add_argument("-a", "--alignfile",
                        help="aln file. Can be either input or name for output file")
    parser.add_argument("--reads", help="FASTQ reads file")
    parser.add_argument("-m", "--unique-threshold",
                        help="unique k-mer threshold", type=int)
    # the reference's long flag name carries a typo ("threhold"), kept
    # verbatim so the accepted flag surface matches exactly
    parser.add_argument("-p", "--ambiguous-threhold",
                        dest="ambiguous_threhold",
                        help="ambiguous k-mer threshold", type=int)
    parser.add_argument("--reverse-complement", action="store_true")
    parser.add_argument("--min-read-quality", type=int, default=None)
    parser.add_argument("--min-kmer-quality", type=int, default=None)
    parser.add_argument("--max-genomes", type=int, default=None)
    parser.add_argument("--filter-similar", action="store_true")
    parser.add_argument("--similarity-threshold", type=float)
    parser.add_argument("--batch-size", type=int, default=DEFAULT_BATCH_SIZE,
                        help="device batch size, 0 = auto by input size "
                             "(no effect on output)")
    parser.add_argument("--profile", action="store_true",
                        help="print per-phase timing/throughput to stderr")
    return parser.parse_args(args)


def _device_build_window() -> Tuple[int, int]:
    """($SHOTGUN_TPU_DEVICE_BUILD_MIN, _MAX); both defaults when either
    is malformed."""
    try:
        return (int(os.environ.get("SHOTGUN_TPU_DEVICE_BUILD_MIN", DEVICE_BUILD_MIN)),
                int(os.environ.get("SHOTGUN_TPU_DEVICE_BUILD_MAX", DEVICE_BUILD_MAX)))
    except ValueError:
        return DEVICE_BUILD_MIN, DEVICE_BUILD_MAX


def create_reference(fasta_file: str, kmer_size: int, filter_similar: bool,
                     similarity_threshold: float, device: torch.device
                     ) -> KmerReference:
    """The database of ``-g``: built on ``device`` (stage
    ``db_build_device``) when the JAX package's gate takes it -- no
    ``--filter-similar``, ``$SHOTGUN_TPU_DEVICE_BUILD`` unset or 1, the
    probe ``auto`` or ``sort``, and the genome codes inside the window --
    and the device build takes the input; otherwise on the host (stage
    ``db_build``)."""
    with phase("fasta_parse"):
        container = FASTAFile(fasta_file).container
    genomes = None
    if (not filter_similar
            and os.environ.get("SHOTGUN_TPU_DEVICE_BUILD", "1") == "1"
            and os.environ.get(PROBE_ENV, "auto") in ("auto", "sort")):
        genomes = (container.to_genome_arrays()
                   if hasattr(container, "to_genome_arrays")
                   else pack_genomes(list(container)))
        lo, hi = _device_build_window()
        if lo <= genomes.codes.size <= hi:
            with phase("db_build_device"):
                ref = KmerReference.from_device_build(genomes, kmer_size, device)
            if ref is not None:
                return ref
    with phase("db_build"):
        return KmerReference(kmer_size, genomes if genomes is not None else container,
                             filter_similar=filter_similar,
                             similarity_threshold=similarity_threshold)


def create_alignment_from_reference(
    kmer_reference: KmerReference, reads_file: str, device: torch.device,
    m: int, p: int, min_read_quality: Optional[int],
    min_kmer_quality: Optional[int], max_genomes: Optional[int],
    batch_size: int = DEFAULT_BATCH_SIZE,
) -> PseudoAlignment:
    """The stream route (native fill, validation inside the fill); an
    input the native scanner rejects is re-read through the regex engine,
    which raises the reference's exact errors."""
    gates = (min_read_quality, min_kmer_quality, max_genomes)
    with phase("table_build"):
        kmer_reference.device_probe_tables(device)
    stream = open_fastq_stream(reads_file, lazy=True)
    if stream is not None:
        alignment = PseudoAlignment(kmer_reference, device)
        try:
            with phase("stream_align"):
                alignment.align_stream(stream, m, p, *gates,
                                       batch_size=batch_size)
            return alignment
        except NativeParseError:
            pass
    with phase("fastq_parse"):
        reads_container = FASTAQFile(reads_file).container
    alignment = PseudoAlignment(kmer_reference, device)
    with phase("align", items=reads_container.num_records):
        alignment.align_reads_from_container(
            reads_container, m, p, *gates, batch_size=batch_size)
    return alignment


def _dumpalign(args: argparse.Namespace, device: torch.device) -> None:
    if args.referencefile and args.reads:
        validate_file_readable(args.reads, "FASTQ reads")
        try:
            kmer_reference = KmerReference.load(args.referencefile)
        except (KDBFormatError, gzip.BadGzipFile):
            sys.exit("Error: Incorrect format of input file.")
    elif args.genomefile and args.kmer_size and args.reads:
        validate_file_readable(args.reads, "FASTQ reads")
        validate_file_readable(args.genomefile, "Genome FASTA")
        kmer_reference = create_reference(
            args.genomefile, args.kmer_size, args.filter_similar,
            args.similarity_threshold, device)
    elif args.alignfile:
        sys.exit("Error: dumpalign -a is not yet ported to shotgun_tpu_torch.")
    else:
        sys.exit("Error: Provide either -g and -k with --reads, "
                 "or -r with --reads, or -a.")
    alignment = create_alignment_from_reference(
        kmer_reference, args.reads, device,
        args.unique_threshold, args.ambiguous_threhold,
        args.min_read_quality, args.min_kmer_quality, args.max_genomes,
        batch_size=args.batch_size,
    )
    print(json.dumps(alignment.get_summary(), indent=4), flush=True)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_arguments(argv)
    if args.profile:
        PROFILER.enable()

    if args.task in ("reference", "dumpref", "align"):
        sys.exit(f"Error: task '{args.task}' is not yet ported to "
                 "shotgun_tpu_torch; use the shotgun_tpu CLI (main.py).")
    if args.task != "dumpalign":
        sys.exit("Error: Unsupported task.")
    # truthiness-based, as in the reference: explicit 0 values pass
    if not ((args.referencefile and args.reads)
            or (args.genomefile and args.kmer_size and args.reads)
            or args.alignfile):
        sys.exit("Error: For task 'dumpalign', provide either -r and --reads, "
                 "or -g, -k, and --reads, or -a.")

    # the reference coerces explicit zeros to the defaults
    if not args.unique_threshold:
        args.unique_threshold = DEFAULT_UNIQUE_THRESHOLD
    if not args.ambiguous_threhold:
        args.ambiguous_threhold = DEFAULT_AMBIGUOUS_THRESHOLD
    if not args.similarity_threshold:
        args.similarity_threshold = DEFAULT_SIMILARITY_THRESHOLD

    try:
        device = resolve_device()
    except RuntimeError as err:
        sys.exit(f"Error: {err}")
    try:
        _dumpalign(args, device)
    except gzip.BadGzipFile:
        sys.exit("Error: Incorrect format of input file.")
    except (InvalidExtensionError, NoRecordsInDataFile, UserInputError) as err:
        sys.exit(err)
    except NotImplementedError as err:
        sys.exit(f"Error: {err}")
    finally:
        PROFILER.report()


if __name__ == "__main__":
    main()
