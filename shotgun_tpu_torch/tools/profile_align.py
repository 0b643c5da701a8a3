"""Where the time of the streamed dumpalign goes, on one device.

    python -m shotgun_tpu_torch.tools.profile_align [--device cuda]
        [--genomes 32] [--genome-len 1000000] [--reads 524288]
        [--strains 0] [--mutation-rate 0] [--error-rate 0]
        [--probe auto|sort|hash|hash16] [--device-build]
        [--batch 32768] [--repeats 5] [--fill-threads N ...] [--out DIR]
        [--batches B ...]

On a synthetic workload (``shotgun_tpu_torch.utils.synth``; by default the
no-overlap, error-free one of ``chip_smoke.py``), one line each:

- database build (on the host, or on the device with ``--device-build``),
  and the making of the ``--probe`` table on the device (host build +
  upload, or the device assembly of a device-built reference's 16-slot
  table);
- the stream align (``PseudoAlignment.align_stream``: native fill,
  upload, device pipeline, one fetch), median of ``--repeats`` runs, at
  the batch given, with the MKQ gate, at a quarter and at twice the
  batch, and at each of ``--fill-threads``;
- the native fill alone, with nothing on the device;
- the device pipeline alone over chunks uploaded beforehand;
- on CUDA, ``torch.profiler`` over one device-only run and one stream
  align: device busy time (the union of the kernel, memcpy and memset
  intervals of the trace, so nothing is counted twice), the idle share
  of the stream (1 - busy / wall of the profiled run) and the device
  time by kernel name.

With ``--batches``, after the build, the table and the statistics, only
``profile_route`` at each batch given (the auto batch's inputs,
``routes.py``): reads/s, device ms a batch, idle share and the peak device
memory of the route's runs.

The last line is one JSON object of every number above.  ``--out`` keeps
the Chrome traces and ``key_averages`` tables there.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from shotgun_tpu_torch.aligner import PseudoAlignment, _lpad, _prefetch_iter
from shotgun_tpu_torch.io import native_available
from shotgun_tpu_torch.io.native import FILL_THREADS_ENV, fill_threads
from shotgun_tpu_torch.io.data_file import open_fastq_stream
from shotgun_tpu_torch.models.pipeline import align_fold_batch, init_fold_carry
from shotgun_tpu_torch.reference import PROBE_ENV, KmerReference
from shotgun_tpu_torch.utils.device import resolve_device
from shotgun_tpu_torch.utils.synth import make_genomes, sample_reads, write_workload

K = 31
READ_LEN = 150
#: Chrome-trace categories of work that occupies the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FILL_ENV = FILL_THREADS_ENV


def device_busy_us(trace_events: Iterable[dict]) -> float:
    """Microseconds in which the device ran at least one kernel, copy or
    memset: the union of those events' intervals in a Chrome trace."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace_events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def device_ms_by_name(trace_events: Iterable[dict], top: int = 12) -> Dict[str, float]:
    """Device milliseconds per kernel/copy name, largest first."""
    by_name: Dict[str, float] = defaultdict(float)
    for e in trace_events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            by_name[e["name"][:80]] += e["dur"] / 1e3
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_s(fn: Callable[[], object], device: torch.device) -> tuple:
    """(``fn()``, its seconds by the host clock from a device
    synchronisation to the next)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def table_bytes(tab) -> int:
    """Bytes of a probe table's tensors (a sort table's key words too)."""
    tensors = [x for t in tab for x in (t if isinstance(t, tuple) else (t,))]
    return sum(t.numel() * t.element_size() for t in tensors)


def _median_s(fn: Callable[[], None], repeats: int, device: torch.device) -> float:
    times = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def stream_align(ref, fastq, device, batch, mkq=None) -> PseudoAlignment:
    """``align_stream`` of the FASTQ ``fastq`` on the native stream route."""
    stream = open_fastq_stream(fastq, lazy=True)
    if stream is None:
        raise RuntimeError("the native stream route cannot read " + fastq)
    pa = PseudoAlignment(ref, device)
    pa.align_stream(stream, min_kmer_quality=mkq, batch_size=batch)
    return pa


def _fill_only(fastq, batch, k) -> int:
    stream = open_fastq_stream(fastq, lazy=True)
    stream.start_validation()
    rows = sum(c[3] for c in _prefetch_iter(
        stream.chunks_packed(batch, _lpad(stream.max_len, k), False)))
    stream.finish_validation()
    return rows


def _chunks_on_device(fastq, batch, k, device) -> List[tuple]:
    stream = open_fastq_stream(fastq, lazy=True)
    stream.start_validation()
    out = [(torch.from_numpy(c).to(device), torch.from_numpy(n).to(device))
           for c, _q, n, _rows in stream.chunks_packed(
               batch, _lpad(stream.max_len, k), False)]
    stream.finish_validation()
    return out


def _device_only(ref, chunks, device) -> None:
    tab = ref.device_probe_tables(device)
    member = ref.set_member_device(device)
    carry = init_fold_carry(member.shape[1], device)
    for codes, lengths in chunks:
        carry = align_fold_batch(carry, tab, member, codes, None, lengths,
                                 1, 1, 0, 0, 0, k=ref.index.k, has_mrq=False,
                                 has_mkq=False, has_mg=False)
    _sync(device)


def profiled(fn: Callable[[], None], device: torch.device, out: Optional[str],
             tag: str) -> dict:
    """One profiled call of ``fn``: wall, device busy and idle share."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(out or tmp, f"{tag}_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    if out:
        with open(os.path.join(out, f"{tag}_key_averages.txt"), "w") as fh:
            fh.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                               row_limit=40))
    busy_ms = device_busy_us(events) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "device_ms_by_name": device_ms_by_name(events)}


def profile_route(ref, fastq: str, device: torch.device, batch: int,
                  repeats: int = 3) -> dict:
    """The measures of ``main`` for ``ref``'s route on the reads of
    ``fastq`` at ``batch``: the stream's reads/s (median of ``repeats``),
    the device pipeline alone over the batches uploaded before (ms a
    batch, median of ``repeats``) and, on CUDA, one profiled stream (wall
    and device busy ms, idle share) and the peak device bytes allocated
    and reserved over these runs, the table included, beside the bytes
    allocated before them (None elsewhere)."""
    def stream():
        stream_align(ref, fastq, device, batch)

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    chunks = _chunks_on_device(fastq, batch, ref.index.k, device)
    n = sum(int((lengths > 0).sum()) for _, lengths in chunks)
    prof = (profiled(stream, device, None, "route") if cuda
            else dict.fromkeys(("wall_ms", "device_busy_ms", "idle_share")))
    device_s = _median_s(lambda: _device_only(ref, chunks, device), repeats, device)
    out = {"reads": n, "stream_reads_per_s": n / _median_s(stream, repeats, device),
           "device_ms_per_batch": 1e3 * device_s / len(chunks),
           "wall_ms": prof["wall_ms"], "busy_ms": prof["device_busy_ms"],
           "idle_share": prof["idle_share"], "base_allocated_bytes": None,
           "peak_allocated_bytes": None, "peak_reserved_bytes": None}
    if cuda:
        out.update(base_allocated_bytes=base,
                   peak_allocated_bytes=torch.cuda.max_memory_allocated(device),
                   peak_reserved_bytes=torch.cuda.max_memory_reserved(device))
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default $SHOTGUN_TPU_TORCH_DEVICE or cuda)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genomes", type=int, default=32)
    ap.add_argument("--genome-len", type=int, default=1_000_000)
    ap.add_argument("--reads", type=int, default=524_288)
    ap.add_argument("--strains", type=int, default=0,
                    help="ancestors the genomes are mutated copies of (0: none)")
    ap.add_argument("--mutation-rate", type=float, default=0.0)
    ap.add_argument("--error-rate", type=float, default=0.0)
    ap.add_argument("--probe", default="auto", choices=["auto", "sort", "hash", "hash16"],
                    help="probe table of every run (sets $SHOTGUN_TPU_PROBE)")
    ap.add_argument("--device-build", action="store_true",
                    help="build the database on the device")
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--fill-threads", type=int, nargs="*", default=[],
                    help="extra native fill thread counts to time the stream at")
    ap.add_argument("--out", default=None, help="directory for traces and tables")
    ap.add_argument("--batches", type=int, nargs="*", default=[],
                    help="only the route's measures (profile_route) at each batch")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if not native_available():
        raise RuntimeError("the native FASTQ library did not build")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    res: dict = {"device": str(device), "workload": {
        k: getattr(args, k) for k in ("seed", "genomes", "genome_len", "reads",
                                      "strains", "mutation_rate", "error_rate",
                                      "batch", "probe", "device_build")}}
    if device.type == "cuda":
        res["card"] = torch.cuda.get_device_name(device)
    say = lambda msg: print(msg, flush=True)  # noqa: E731

    rng = np.random.default_rng(args.seed)
    genomes = make_genomes(rng, args.genomes, args.genome_len, args.strains,
                           args.mutation_rate)
    work = sample_reads(rng, genomes, args.reads, READ_LEN, args.error_rate)
    probe_env = os.environ.get(PROBE_ENV)
    os.environ[PROBE_ENV] = args.probe
    try:
        _run(args, device, genomes, work, res, say)
    finally:
        if probe_env is None:
            os.environ.pop(PROBE_ENV, None)
        else:
            os.environ[PROBE_ENV] = probe_env
    print(json.dumps(res), flush=True)
    return res


def _run(args, device, genomes, work, res: dict, say) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        fasta, fastq = os.path.join(tmp, "g.fa"), os.path.join(tmp, "r.fq")
        write_workload(work, fasta, fastq)
        n = args.reads

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        if args.device_build:
            ref = KmerReference.from_device_build(genomes, K, device)
            if ref is None:
                raise RuntimeError("the device build does not take this workload")
        else:
            ref = KmerReference(K, genomes, device=device)
        _sync(device)
        res["db_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tab = ref.device_probe_tables(device)
        _sync(device)
        res["table_s"] = time.perf_counter() - t0
        method = ref.probe_method()
        res.update(probe_used=method, distinct_kmers=int(ref.index.num_kmers),
                   table_bytes=table_bytes(tab))
        say(f"db build ({'device' if args.device_build else 'host'}) "
            f"{res['db_build_s']:.3f} s, {method} table on the device "
            f"{res['table_s']:.3f} s: {res['distinct_kmers']} distinct k-mers, "
            f"table {res['table_bytes']} B")

        stats = stream_align(ref, fastq, device, args.batch).get_summary()["Statistics"]
        res["statistics"] = stats
        say(f"workload statistics: {stats}")
        if args.batches:
            res["by_batch"] = {}
            for b in args.batches:
                r = res["by_batch"][b] = profile_route(ref, fastq, device, b, args.repeats)
                say(f"B={b}: stream {r['stream_reads_per_s']:.0f} reads/s "
                    f"({r['reads'] / r['stream_reads_per_s']:.4f} s), device pipeline "
                    f"alone {r['device_ms_per_batch']:.3f} ms a batch, idle share "
                    f"{r['idle_share']}, peak device memory {r['peak_allocated_bytes']} B "
                    f"allocated, {r['peak_reserved_bytes']} B reserved "
                    f"({r['base_allocated_bytes']} B before)")
            return

        def stream(batch, mkq=None):
            return lambda: stream_align(ref, fastq, device, batch, mkq)

        runs = {f"B={args.batch}": stream(args.batch),
                f"B={args.batch} mkq=30": stream(args.batch, 30),
                f"B={args.batch // 4}": stream(args.batch // 4),
                f"B={args.batch * 2}": stream(args.batch * 2)}
        res["stream_reads_per_s"] = {}
        for name, fn in runs.items():
            s = _median_s(fn, args.repeats, device)
            res["stream_reads_per_s"][name] = n / s
            say(f"stream align {name}: median {s:.4f} s = {n / s:.0f} reads/s")
        saved_threads = os.environ.get(FILL_ENV)
        res["fill_only_reads_per_s"] = {}
        for nt in [None] + args.fill_threads:
            if nt is not None:
                os.environ[FILL_ENV] = str(nt)
            s = _median_s(lambda: _fill_only(fastq, args.batch, K), args.repeats,
                          device)
            tag = f"threads={os.environ.get(FILL_ENV, f'{fill_threads()} (default)')}"
            res["fill_only_reads_per_s"][tag] = n / s
            say(f"native fill alone, {tag}: median {s:.4f} s = {n / s:.0f} reads/s")
            if nt is not None:
                s = _median_s(stream(args.batch), args.repeats, device)
                res["stream_reads_per_s"][f"B={args.batch} {tag}"] = n / s
                say(f"stream align B={args.batch} {tag}: median {s:.4f} s = "
                    f"{n / s:.0f} reads/s")
        if saved_threads is None:
            os.environ.pop(FILL_ENV, None)
        else:
            os.environ[FILL_ENV] = saved_threads

        chunks = _chunks_on_device(fastq, args.batch, K, device)
        s = _median_s(lambda: _device_only(ref, chunks, device), args.repeats,
                      device)
        res["device_only_reads_per_s"] = n / s
        say(f"device pipeline alone ({len(chunks)} batches uploaded before): "
            f"median {s:.4f} s = {n / s:.0f} reads/s, "
            f"{s / len(chunks) * 1e3:.3f} ms per batch")

        if device.type == "cuda":
            for tag, fn in (("device_only", lambda: _device_only(ref, chunks, device)),
                            ("stream", stream(args.batch))):
                p = profiled(fn, device, args.out, tag)
                res[f"profiled_{tag}"] = p
                say(f"profiled {tag}: wall {p['wall_ms']:.3f} ms, device busy "
                    f"{p['device_busy_ms']:.3f} ms, idle share {p['idle_share']:.4f}")
                for name, ms in p["device_ms_by_name"].items():
                    say(f"    {ms:10.3f} ms  {name}")
            res["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
            say(f"peak device memory {res['peak_device_bytes']} B")
        else:
            say("device busy time and idle share: not measured (no CUDA device)")


if __name__ == "__main__":
    main()
