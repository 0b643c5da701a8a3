"""Command-line interface of the port (counterpart of
``shotgun_tpu/cli.py``): ``python -m shotgun_tpu_torch``.

The four tasks of the reference CLI (``reference``, ``dumpref``,
``align``, ``dumpalign``) with the JAX package's flag surface, per-task
validation, defaulting quirks, error strings and exit codes, and its
files (``.kdb``, ``.aln``).  Databases are built on the host, except for
``dumpalign -g``, which builds on the device for genomes inside the
device's window (``routes.device_routes``: 4-64 Mbp off a card, the JAX
package's) as the JAX package's does (``dumpalign_reference``): only
dumpalign never needs the host postings.  Any k >= 1 aligns (k > 31 by
the sort join of multi-word keys); at k < 1 no read maps.
``dumpalign -r/-g`` runs over a device mesh when the environment asks for
one (``parallel.distributed initialize_from_env``: ``SHOTGUN_TPU_NPROCS``
processes, or ``SHOTGUN_TPU_MESH=data`` over the local devices), as the
JAX package's does: the reads parsed whole and sharded, the database of
``-g`` built on the host, and only process 0 printing the summary.

The device comes from ``$SHOTGUN_TPU_TORCH_DEVICE`` (default ``cuda``;
asking for CUDA without it is an error, never a silent CPU run).
"""

from __future__ import annotations

import argparse
import ctypes
import gzip
import json
import os
import sys
from typing import List, Optional, Tuple

import torch

from shotgun_tpu_torch.constants import (
    DEFAULT_AMBIGUOUS_THRESHOLD,
    DEFAULT_SIMILARITY_THRESHOLD,
    DEFAULT_UNIQUE_THRESHOLD,
)
from shotgun_tpu_torch.errors import UserInputError
from shotgun_tpu_torch.io.data_file import (
    FASTAFile,
    FASTAQFile,
    InvalidExtensionError,
    NoRecordsInDataFile,
    open_fastq_stream,
)
from shotgun_tpu_torch.io.native import NativeParseError
from shotgun_tpu_torch.io.packing import pack_genomes
from shotgun_tpu_torch.aligner import (
    AddingExistingRead,
    NotValidatingUniqueMapping,
    PseudoAlignment,
)
from shotgun_tpu_torch.parallel import distributed
from shotgun_tpu_torch.parallel.mesh import Mesh
from shotgun_tpu_torch.reference import PROBE_ENV, KDBFormatError, KmerReference
from shotgun_tpu_torch.routes import device_routes
from shotgun_tpu_torch.utils.device import resolve_device
from shotgun_tpu_torch.utils.profiling import PROFILER, phase

#: 0 = auto: ``routes.Routes.auto_batch`` picks by device and input size
DEFAULT_BATCH_SIZE = 0


# ---------------------------------------------------------------------------
# file validation (reference main.py:30-54)
# ---------------------------------------------------------------------------

def validate_file_readable(filepath: str, description: str) -> None:
    if not os.path.isfile(filepath):
        sys.exit(f"Error: {description} file '{filepath}' does not exist or is not a file.")
    if not os.access(filepath, os.R_OK):
        sys.exit(f"Error: {description} file '{filepath}' is not readable.")


def validate_file_writable(filepath: str, description: str) -> None:
    dir_path = os.path.dirname(filepath) or "."
    if os.path.exists(filepath) and not os.access(filepath, os.W_OK):
        sys.exit(f"Error: {description} file '{filepath}' is not writable.")
    if not os.path.exists(filepath) and not os.access(dir_path, os.W_OK):
        sys.exit(
            f"Error: Directory '{dir_path}' is not writable to create "
            f"{description} file '{filepath}'."
        )


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


# ---------------------------------------------------------------------------
# databases
# ---------------------------------------------------------------------------

def _device_build_window(device: torch.device) -> Tuple[int, int]:
    """($SHOTGUN_TPU_DEVICE_BUILD_MIN, _MAX), each unset ``device``'s
    (``routes.device_routes``); both the device's when either is
    malformed."""
    r = device_routes(device)
    try:
        return (int(os.environ.get("SHOTGUN_TPU_DEVICE_BUILD_MIN", r.device_build_min)),
                int(os.environ.get("SHOTGUN_TPU_DEVICE_BUILD_MAX", r.device_build_max)))
    except ValueError:
        return r.device_build_min, r.device_build_max


def create_reference(fasta_file: str, kmer_size: int, filter_similar: bool,
                     similarity_threshold: float, device: torch.device,
                     container=None) -> KmerReference:
    """The database of ``-g``, built on the host (stage ``db_build``);
    EXTSIM's overlap matrix runs on ``device``.  ``container``: the FASTA
    already parsed."""
    if container is None:
        with phase("fasta_parse"):
            container = FASTAFile(fasta_file).container
    with phase("db_build"):
        return KmerReference(kmer_size, container,
                             filter_similar=filter_similar,
                             similarity_threshold=similarity_threshold,
                             device=device)


def dumpalign_reference(fasta_file: str, kmer_size: int, filter_similar: bool,
                        similarity_threshold: float, device: torch.device
                        ) -> KmerReference:
    """The database of ``dumpalign -g``: built on ``device`` (stage
    ``db_build_device``) when the JAX package's gate takes it -- no
    ``--filter-similar``, ``$SHOTGUN_TPU_DEVICE_BUILD`` unset or 1, the
    probe ``auto`` or ``sort``, and the genome codes inside the window --
    and the device build takes the input; otherwise on the host.  Such a
    reference has no host postings, so no other task may use it."""
    with phase("fasta_parse"):
        container = FASTAFile(fasta_file).container
    if (not filter_similar
            and os.environ.get("SHOTGUN_TPU_DEVICE_BUILD", "1") == "1"
            and os.environ.get(PROBE_ENV, "auto") in ("auto", "sort")):
        genomes = (container.to_genome_arrays()
                   if hasattr(container, "to_genome_arrays")
                   else pack_genomes(list(container)))
        lo, hi = _device_build_window(device)
        if lo <= genomes.codes.size <= hi:
            with phase("db_build_device"):
                ref = KmerReference.from_device_build(genomes, kmer_size, device)
            if ref is not None:
                return ref
            container = genomes
    return create_reference(fasta_file, kmer_size, filter_similar,
                            similarity_threshold, device, container=container)


def load_reference(reference_file: str, device: torch.device) -> KmerReference:
    try:
        with phase("kdb_load"):
            return KmerReference.load(reference_file, device)
    except (KDBFormatError, gzip.BadGzipFile):
        sys.exit("Error: Incorrect format of input file.")


def save_reference(kmer_reference: KmerReference, reference_file: str) -> None:
    with phase("kdb_save"):
        kmer_reference.save(reference_file)


def dump_reference(kmer_reference: KmerReference) -> None:
    """The dumpref JSON, streamed (``KmerReference.write_summary``), and
    the newline ``print`` ends the reference's with."""
    with phase("dumpref"):
        kmer_reference.write_summary(sys.stdout)
        print()


# ---------------------------------------------------------------------------
# alignments
# ---------------------------------------------------------------------------

def create_alignment_from_reference(
    kmer_reference: KmerReference, reads_file: str, device: torch.device,
    m: int, p: int, min_read_quality: Optional[int],
    min_kmer_quality: Optional[int], max_genomes: Optional[int],
    batch_size: int = DEFAULT_BATCH_SIZE, store_reads: bool = False,
    mesh: Optional[Mesh] = None,
) -> PseudoAlignment:
    """The stream route (native fill, validation inside the fill); an
    input the native scanner rejects is re-read through the regex engine,
    which raises the reference's exact errors.  ``store_reads``: the align
    task's read store.  With a ``mesh`` (dumpalign only), the JAX CLI's
    mesh route: the reads parsed whole (the container route), every
    process holding the batch, and aligned sharded over the mesh."""
    gates = (min_read_quality, min_kmer_quality, max_genomes)
    with phase("table_build"):
        kmer_reference.device_probe_tables(device)
    stream = None
    if mesh is None:
        with phase("stream_open"):
            stream = open_fastq_stream(reads_file, lazy=True)
    if stream is not None:
        alignment = PseudoAlignment(kmer_reference, device)
        try:
            with phase("stream_align"):
                alignment.align_stream(stream, m, p, *gates,
                                       batch_size=batch_size,
                                       store_reads=store_reads)
            return alignment
        except NativeParseError:
            pass
    with phase("fastq_parse"):
        reads_container = FASTAQFile(reads_file).container
    alignment = PseudoAlignment(kmer_reference, device)
    with phase("align", items=reads_container.num_records):
        alignment.align_reads_from_container(
            reads_container, m, p, *gates, batch_size=batch_size,
            store_reads=store_reads, mesh=mesh)
    return alignment


def _print_summary(alignment: PseudoAlignment, mesh: Optional[Mesh] = None) -> None:
    """The dumpalign JSON; under a mesh only from process 0 (every process
    holds the same merged result), after the C-level stdio buffers, where
    a collective backend may have written, are flushed."""
    if mesh is not None:
        if not distributed.is_primary():
            return
        ctypes.CDLL(None).fflush(None)
    print(json.dumps(alignment.get_summary(), indent=4), flush=True)


# ---------------------------------------------------------------------------
# tasks (reference main.py:317-402)
# ---------------------------------------------------------------------------

def _validate_task(args: argparse.Namespace) -> None:
    """Per-task flag combinations.  Truthiness-based, as in the reference
    (main.py:321-334): explicit 0 values pass."""
    if args.task == "reference":
        if (args.reads or args.alignfile or args.unique_threshold
                or args.ambiguous_threhold or args.min_read_quality
                or args.min_kmer_quality or args.max_genomes):
            sys.exit("Error: For task 'reference', only -g, -k, -r, "
                     "--filter-similar, and --similarity-threshold are allowed.")
    elif args.task == "dumpref":
        if (args.reads or args.alignfile or args.unique_threshold
                or args.ambiguous_threhold or args.min_read_quality
                or args.min_kmer_quality or args.max_genomes):
            sys.exit("Error: For task 'dumpref', only -r or (-g and -k) with "
                     "--filter-similar and --similarity-threshold are allowed.")
    elif args.task == "align":
        if not ((args.referencefile and args.reads and args.alignfile)
                or (args.genomefile and args.kmer_size and args.reads
                    and args.alignfile)):
            sys.exit("Error: For task 'align', provide either -r (reference file) "
                     "or -g and -k (genome file and kmer size) along with "
                     "--reads and -a.")
    elif args.task == "dumpalign":
        if not ((args.referencefile and args.reads)
                or (args.genomefile and args.kmer_size and args.reads)
                or args.alignfile):
            sys.exit("Error: For task 'dumpalign', provide either -r and --reads, "
                     "or -g, -k, and --reads, or -a.")
    else:
        sys.exit("Error: Unsupported task.")


def _dumpalign_mesh(device: torch.device) -> Tuple[Optional[Mesh], torch.device]:
    """dumpalign's mesh from the environment, as the JAX CLI's (its
    ``cli.py:458-464``), and the device this process computes on; with
    ``--profile`` the mesh is reported on stderr."""
    mesh = distributed.initialize_from_env()
    if mesh is None:
        return None, device
    if PROFILER.enabled:
        backend = (torch.distributed.get_backend(mesh.group) if mesh.group is not None
                   else "none")
        print(f"mesh: {mesh.shape}, devices {[str(d) for d in mesh.devices]}, "
              f"backend {backend}", file=sys.stderr, flush=True)
    return mesh, mesh.devices[0]


def _run_task(args: argparse.Namespace, device: torch.device) -> None:
    gates = (args.unique_threshold, args.ambiguous_threhold,
             args.min_read_quality, args.min_kmer_quality, args.max_genomes)
    mesh = None
    if args.task == "dumpalign":
        mesh, device = _dumpalign_mesh(device)
    if args.task == "reference":
        validate_file_readable(args.genomefile, "Genome FASTA")
        validate_file_writable(args.referencefile, "Reference database output")
        save_reference(create_reference(
            args.genomefile, args.kmer_size, args.filter_similar,
            args.similarity_threshold, device), args.referencefile)
    elif args.task == "dumpref":
        if args.referencefile:
            validate_file_readable(args.referencefile, "Reference database")
            dump_reference(load_reference(args.referencefile, device))
        elif args.genomefile and args.kmer_size:
            validate_file_readable(args.genomefile, "Genome FASTA")
            dump_reference(create_reference(
                args.genomefile, args.kmer_size, args.filter_similar,
                args.similarity_threshold, device))
    elif args.task == "align":
        validate_file_readable(args.reads, "FASTQ reads")
        validate_file_writable(args.alignfile, "Alignment output")
        # -r wins over -g, as in the JAX package's CLI (its -g branch
        # exits before its build-and-save, cli.py:442-457): the database
        # is read from -r, which must exist, and -g is not read
        if args.referencefile:
            validate_file_readable(args.referencefile, "Reference database")
        else:
            validate_file_readable(args.genomefile, "Genome FASTA")
            # the reference crashes here (it saves to None, main.py:372);
            # the JAX package exits cleanly instead
            sys.exit("Error: For task 'align' with -g, also provide -r "
                     "to store the reference database.")
        alignment = create_alignment_from_reference(
            load_reference(args.referencefile, device), args.reads, device, *gates,
            batch_size=args.batch_size, store_reads=True)
        with phase("aln_save"):
            alignment.save(args.alignfile)
    elif args.referencefile and args.reads:  # dumpalign
        validate_file_readable(args.reads, "FASTQ reads")
        _print_summary(create_alignment_from_reference(
            load_reference(args.referencefile, device), args.reads, device, *gates,
            batch_size=args.batch_size, mesh=mesh), mesh)
    elif args.genomefile and args.kmer_size and args.reads:
        validate_file_readable(args.reads, "FASTQ reads")
        validate_file_readable(args.genomefile, "Genome FASTA")
        # under a mesh the database is built on the host, as in the JAX
        # CLI (its device build is single-device)
        build = create_reference if mesh is not None else dumpalign_reference
        _print_summary(create_alignment_from_reference(
            build(args.genomefile, args.kmer_size, args.filter_similar,
                  args.similarity_threshold, device),
            args.reads, device, *gates, batch_size=args.batch_size, mesh=mesh), mesh)
    else:
        validate_file_readable(args.alignfile, "Alignment output")
        try:
            with phase("aln_load"):
                alignment = PseudoAlignment.load(args.alignfile, device)
        except (KDBFormatError, gzip.BadGzipFile):
            sys.exit("Error: Incorrect format of input file.")
        _print_summary(alignment)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_arguments(argv)
    if args.profile:
        PROFILER.enable()
    _validate_task(args)

    # the reference coerces explicit zeros to the defaults (main.py:337-342)
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
        _run_task(args, device)
    except gzip.BadGzipFile:
        sys.exit("Error: Incorrect format of input file.")
    except (InvalidExtensionError, NoRecordsInDataFile,
            NotValidatingUniqueMapping, AddingExistingRead,
            UserInputError) as err:
        sys.exit(err)
    finally:
        PROFILER.report()
        distributed.shutdown()


if __name__ == "__main__":
    main()
