"""One run of a cell: inputs from the seed, set-up, warm-up, the measured
window, the check against the plain reference, and the result line.

Two traffic kinds, named by a traffic file's ``kind``:

- ``resident``: a database built once in set-up
  (``KmerReference.from_device_build`` on the seed's genomes) and a closed
  loop of samples, one at a time, each ``cli.create_alignment_from_reference``
  and ``get_summary()``, cycling over the traffic's sample files;
- ``oneshot``: a closed loop of whole ``dumpalign -g`` runs in process,
  each ``cli.dumpalign_reference`` of the FASTA (parse, device build),
  ``cli.create_alignment_from_reference`` (table, stream) and
  ``get_summary()``.

The program is the port, ``shotgun_tpu_torch``; the harness takes from it
only the calls above, its phase spans (``utils.profiling.PROFILER``), its
table's geometry, its auto batch and, for the fill alone, its FASTQ
stream.  Every answer produced in the run is compared with the plain
reference's (``reference.py``) once the window has closed.

A cell whose configuration has a ``mesh`` runs as one process a card
(``procs.py``): each makes the same requests with ``mesh=``, in lockstep,
process 0 alone writes the input files and decides when the window ends,
and it checks every process's answers.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from shotbench import gen, reference
from shotbench.cells import Cell, load_cell
from shotbench.procs import Procs
from shotbench.trace import WINDOW_SPAN, Trace, profiler, read_device, read_trace
from shotbench.yardstick import h1_bytes, h2_bytes, h3_bytes

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "shotgun_tpu")
#: every compared number must be at most its limit (exact comparisons)
LIMITS = {"failed_requests": 0, "mismatched_summaries": 0, "max_count_gap": 0,
          "order_differs": 0}


class ForbiddenModules(RuntimeError):
    pass


@dataclass
class Request:
    file_no: int
    reads: int
    batches: int
    wall_s: float = 0.0
    text: Optional[str] = None      # the summary as the CLI prints it; None if it failed


@dataclass
class RunData:
    """What a run measured; the metric readers take it."""

    kind: str
    setup_s: float
    window_s: float = 0.0
    requests: List[Request] = field(default_factory=list)
    trace: Optional[Trace] = None
    spans: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    fill: Optional[Tuple[int, float]] = None         # (reads, seconds)
    launches: Dict[str, List[int]] = field(default_factory=dict)  # kernel -> bytes each


def row_stride(read_len: int, k: int) -> int:
    """The stream's padded row: the read length rounded up to 32 bases."""
    return ((max(read_len, k) + 31) // 32) * 32


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Inputs:
    """A cell's inputs from the seed: genomes, samples and their files
    under ``tmp``.  Nothing of the program."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, tmp: str,
                 primary: bool = True) -> None:
        """``primary``: also make the samples and write the files (a
        process of a multi-process run other than 0 makes the genomes
        alone and reads process 0's files)."""
        self.cell, self.seed, self.device, self.tmp = cell, seed, device, tmp
        self.primary = primary
        cfg, tr = cell.config, cell.traffic
        self.k, self.read_len = cfg["k"], cfg["read_len"]
        self.gates = reference.Gates.from_traffic(tr.get("gates", {}))
        self.setup_steps: Dict[str, float] = {}
        t0 = time.perf_counter()
        genomes = gen.make_genomes(cfg, seed, device)
        self.samples: List[gen.Sample] = []
        self.paths: List[str] = []
        for f in range(tr["sample_files"]):
            path = os.path.join(tmp, f"sample_{f}.fq")
            if primary:
                sample = gen.make_sample(genomes, cfg, tr, seed, f, device)
                gen.write_fastq(path, sample, f, device)
                self.samples.append(sample)
            self.paths.append(path)
        self.descriptions = list(genomes.descriptions)
        self.offsets = genomes.offsets
        self.codes = genomes.codes.cpu().numpy()
        del genomes
        self.n_reads = tr["reads_per_sample"]
        _sync(device)
        self.setup_steps["inputs"] = time.perf_counter() - t0


class Kind(Inputs):
    """Set-up and requests of one traffic kind."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, tmp: str,
                 procs: Optional[Procs] = None) -> None:
        from shotgun_tpu_torch.routes import device_routes

        self.procs = procs
        self.mesh = None if procs is None else procs.mesh
        super().__init__(cell, seed, device, tmp, procs is None or procs.primary)
        self.batch = device_routes(device).auto_batch(self.n_reads)
        t0 = time.perf_counter()
        self.prepare()
        _sync(device)
        self.setup_steps["program"] = time.perf_counter() - t0

    def prepare(self) -> None:
        """Set-up of the program before the warm-up."""

    def answer(self, path: str) -> dict:
        raise NotImplementedError

    def request(self, i: int) -> Request:
        f = i % len(self.paths)
        req = Request(f, self.n_reads, math.ceil(self.n_reads / self.batch))
        t0 = time.perf_counter()
        try:
            with record_function(f"shotbench.{self.cell.traffic['kind']}"):
                summary = self.answer(self.paths[f])
            req.wall_s = time.perf_counter() - t0
            req.text = reference.summary_text(summary)
        except Exception as exc:  # a request that fails is counted, not fatal
            req.wall_s = time.perf_counter() - t0
            print(f"request {i} failed: {type(exc).__name__}: {exc}", file=sys.stderr)
            if self.procs is not None:
                raise  # the others wait in a collective for this process
        return req

    def gate_args(self) -> tuple:
        g = self.gates
        return (g.m, g.p, g.min_read_quality, g.min_kmer_quality, g.max_genomes)

    def release(self) -> None:
        """Drop the program's state, so the reference runs beside nothing."""

    def measure_fill(self) -> Optional[Tuple[int, float]]:
        return None

    def launch_bytes(self, requests: List[Request]) -> Dict[str, List[int]]:
        return {}


class Resident(Kind):
    def prepare(self) -> None:
        from shotgun_tpu_torch.io.packing import GenomeArrays
        from shotgun_tpu_torch.reference import KmerReference

        arrays = GenomeArrays(self.descriptions, self.codes, self.offsets)
        self.ref = KmerReference.from_device_build(arrays, self.k, self.device)
        if self.ref is None:
            raise RuntimeError("the device build does not take this configuration")

    def answer(self, path: str) -> dict:
        from shotgun_tpu_torch import cli

        aln = cli.create_alignment_from_reference(self.ref, path, self.device,
                                                  *self.gate_args(), mesh=self.mesh)
        return aln.get_summary()

    def release(self) -> None:
        self._table = self._table_geometry() if self.mesh is None else None
        self.ref = None

    def _table_geometry(self) -> Optional[Tuple[int, int, int]]:
        """(buckets, row bytes, stash rows) of the probe table the stream
        used, None for the sort join."""
        tab = self.ref.device_probe_tables(self.device)
        if not hasattr(tab, "table"):
            return None
        t = tab.table
        return t.shape[0], t.shape[1] * t.shape[2] * t.element_size(), tab.stash.shape[0]

    def measure_fill(self) -> Optional[Tuple[int, float]]:
        """The native fill alone over every sample file, nothing on the
        device: ``FASTAQStream.chunks_packed`` at the run's batch."""
        from shotgun_tpu_torch.io.data_file import open_fastq_stream

        g = self.gates
        with_qual = g.min_read_quality is not None or g.min_kmer_quality is not None
        lpad = row_stride(self.read_len, self.k)
        reads, t0 = 0, time.perf_counter()
        for path in self.paths:
            stream = open_fastq_stream(path, lazy=True)
            stream.start_validation()
            for chunk in stream.chunks_packed(self.batch, lpad, with_qual):
                reads += int(chunk[3])
            stream.finish_validation()
        return reads, time.perf_counter() - t0

    def launch_bytes(self, requests: List[Request]) -> Dict[str, List[int]]:
        """The bytes of each encode and H2 launch the requests made, in
        order: one launch of each a batch of [batch, row stride] positions.
        The encode is H1 ``encode_window`` at k <= 31 and H3
        ``encode_words`` past it, where the stream takes the sort join.
        Nothing under a mesh, whose launches the cell that runs one counts."""
        if self.mesh is not None:
            return {}
        lpad = row_stride(self.read_len, self.k)
        sums = self.gates.min_kmer_quality is not None
        if self.k > reference.WORD_BASES:
            h3 = h3_bytes(self.batch, lpad // 4, self.k, sums)
            return {"encode_words": [h3] * sum(r.batches for r in requests)}
        h1 = h1_bytes(self.batch, lpad // 4, self.k, True, sums)
        out: Dict[str, List[int]] = {"encode_window": [], "hash_probe": []}
        per_file: Dict[int, List[int]] = {}
        for req in requests:
            out["encode_window"] += [h1] * req.batches
            if self._table is None:
                continue
            if req.file_no not in per_file:
                per_file[req.file_no] = self._h2_file(req.file_no, lpad)
            out["hash_probe"] += per_file[req.file_no]
        if self._table is None:
            del out["hash_probe"]
        return out

    def _h2_file(self, f: int, lpad: int) -> List[int]:
        n_buckets, row_bytes, stash_rows = self._table
        codes = self.samples[f].codes
        out = []
        for a in range(0, codes.shape[0], self.batch):
            rows = torch.zeros((self.batch, lpad), dtype=torch.uint8, device=self.device)
            part = torch.from_numpy(codes[a: a + self.batch]).to(self.device)
            rows[: part.shape[0], : part.shape[1]] = part
            out.append(h2_bytes(n_buckets, row_bytes, stash_rows,
                                reference.window_keys(rows, self.k))[0])
        return out


class Oneshot(Kind):
    def prepare(self) -> None:
        self.fasta = os.path.join(self.tmp, "genomes.fa")
        if self.primary:
            gen.write_fasta(self.fasta, gen.Genomes(
                self.descriptions, torch.from_numpy(self.codes), self.offsets))

    def answer(self, path: str) -> dict:
        from shotgun_tpu_torch import cli
        from shotgun_tpu_torch.constants import DEFAULT_SIMILARITY_THRESHOLD

        ref = cli.dumpalign_reference(self.fasta, self.k, False,
                                      DEFAULT_SIMILARITY_THRESHOLD, self.device)
        aln = cli.create_alignment_from_reference(ref, path, self.device,
                                                  *self.gate_args(), mesh=self.mesh)
        return aln.get_summary()


KINDS = {"resident": Resident, "oneshot": Oneshot}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(kind: Kind, seconds: float) -> Tuple[List[Request], float]:
    """Requests one after another until ``seconds`` have passed (on
    process 0's clock, in a multi-process run); the window ends with its
    last request."""
    reqs: List[Request] = []
    with record_function(WINDOW_SPAN):
        t0 = time.perf_counter()
        while True:
            reqs.append(kind.request(len(reqs) + 1))
            done = time.perf_counter() - t0 >= seconds
            if kind.procs is not None:
                done = kind.procs.agree(done)
            if done:
                break
        _sync(kind.device)
        return reqs, time.perf_counter() - t0


def check(kind: Kind, requests: List[Request]) -> Dict[str, int]:
    """Every answer against the plain reference's for its sample file."""
    return compare([r.text for r in requests], [r.file_no for r in requests],
                   expected(kind))


def expected(kind: Inputs, key_map=None) -> Dict[int, str]:
    """The reference's summary text of each sample file."""
    dev = kind.device
    index = reference.build_index(torch.from_numpy(kind.codes).to(dev), kind.offsets,
                                  kind.k, key_map)
    out = {f: reference.summary_text(reference.summarize(
        index, s.codes, s.qual, kind.k, kind.gates, kind.descriptions, dev, key_map))
        for f, s in enumerate(kind.samples)}
    del index
    return out


def compare(texts: List[Optional[str]], files: List[int], want: Dict[int, str]
            ) -> Dict[str, int]:
    out = dict.fromkeys(LIMITS, 0)
    for text, f in zip(texts, files):
        if text is None:
            out["failed_requests"] += 1
            continue
        if text != want[f]:
            out["mismatched_summaries"] += 1
            gaps = reference.count_gaps(json.loads(text), json.loads(want[f]))
            for name, v in gaps.items():
                out[name] = max(out[name], v)
    return out


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, procs: Optional[Procs] = None
             ) -> Optional[dict]:
    """One run of cell ``name``; the result line's object (None on a
    process of a multi-process run other than 0).  Raises
    ``ForbiddenModules`` when the window leaves one loaded."""
    cell = load_cell(root, name)
    cuda = device.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="shotbench-") if procs is None else procs.tmp
    try:
        kind = KINDS[cell.traffic["kind"]](cell, seed, device, tmp, procs)
        if procs is not None:
            procs.barrier()  # process 0's files are written
        t0 = time.perf_counter()
        warm = kind.request(0)
        _sync(device)
        kind.setup_steps["warm_up"] = time.perf_counter() - t0
        print("set-up steps (s): " + ", ".join(f"{n} {v:.3f}" for n, v in
                                               kind.setup_steps.items()),
              file=sys.stderr, flush=True)
        if procs is not None:
            procs.barrier()  # every process set up: the windows open together
        run = RunData(kind=cell.traffic["kind"], setup_s=time.perf_counter() - t_start)
        if trace:
            from shotgun_tpu_torch.utils.profiling import PROFILER

            PROFILER.enable()
            PROFILER.stats.clear()
            with profiler(cuda) as prof:
                run.requests, run.window_s = window(kind, seconds)
            run.spans = {n: (s.seconds, s.calls) for n, s in PROFILER.stats.items()}
            part = "" if procs is None else f"_{procs.rank}"
            run.trace = read_trace(prof, os.path.join(tmp, f"trace{part}.json"))
            del prof
        elif cuda and any(m.source == "device_trace" for m in cell.end_to_end):
            with profiler(cuda, host=False) as prof:
                run.requests, run.window_s = window(kind, seconds)
            part = "" if procs is None else f"_{procs.rank}"
            run.trace = read_device(prof, os.path.join(tmp, f"device{part}.json"),
                                    run.window_s)
            del prof
        else:
            run.requests, run.window_s = window(kind, seconds)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        walls = sorted(r.wall_s for r in run.requests)
        print(f"window {run.window_s:.3f} s: {len(walls)} requests, wall min "
              f"{walls[0]:.4f} median {walls[len(walls) // 2]:.4f} max {walls[-1]:.4f} s",
              file=sys.stderr, flush=True)
        bad = forbidden_loaded()
        if bad:
            raise ForbiddenModules(f"loaded after the window: {', '.join(bad)}")
        if trace and kind.primary:
            run.fill = kind.measure_fill()
        kind.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        answers = [warm] + run.requests
        cards = [(peak, run.trace.busy_s if run.trace is not None else None)]
        if procs is not None:
            # after every process has released the program's state
            gathered = procs.gather((answers, cards[0]))
            procs.close()
            if not procs.primary:
                return None
            answers = [a for got, _ in gathered for a in got]
            cards = [card for _, card in gathered]
        if trace:
            run.launches = kind.launch_bytes(run.requests)
        t0 = time.perf_counter()
        checks = check(kind, answers)
        print(f"reference check {time.perf_counter() - t0:.3f} s over {len(answers)} "
              f"answers", file=sys.stderr, flush=True)
    finally:
        if procs is None:
            shutil.rmtree(tmp, ignore_errors=True)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": max(p for p, _ in cards)}
    result = {"correct": all(checks[n] <= LIMITS[n] for n in LIMITS),
              "attempted": len(answers),
              "failed": checks["failed_requests"],
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev.update(busy_s=sum(b for _, b in cards) / len(cards),
                   window_s=run.trace.window_s)
        if procs is not None:
            dev["cards"] = [{"card": i, "busy_s": b, "memory_peak_bytes": p}
                            for i, (p, b) in enumerate(cards)]
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {n: {"value": checks[n], "limit": LIMITS[n]} for n in LIMITS}
    return result

