"""Phase profile of the device DB build (``index/device_build.py``): host
prep, upload, device compute and fetch, then the warm end-to-end
``KmerReference.from_device_build`` (the port's counterpart of the JAX
repo's ``tools/profile_devbuild.py``).

    python -m shotgun_tpu_torch.tools.profile_devbuild [MBP ...]
        [--device cuda|cpu] [--cli | --build-cost]

For each size (default 1 and 32 Mbp): random genomes from
``default_rng(0)``, 5 records below 8 Mbp and 8 from 8 Mbp up, k = 31.
The build's four steps, as ``device_build_tables`` calls them:

- ``_host_prep``: the 2-bit packing and the N runs, timed warm (the
  second of two calls);
- one warm upload and compute, untimed;
- then three times, each on a fresh copy of the packed buffer: ``_upload``
  (the buffer, the N runs and the record starts to the device),
  ``_compute`` (window keys by kernel H1, validity, the sort, the genome
  counts and the multi-set numbering) and ``_fetch`` (the multi sets'
  (set, record) pairs to the host and the set masks made there), each
  timed by the host clock up to a device synchronisation;
- ``from_device_build`` warm (the second of two calls), then the
  probe table of the auto route (``device_probe_tables``); on CUDA the
  peak device bytes of each, allocated and reserved, above what was
  allocated before them.

With ``--cli``, for each size instead: the CLI's ``dumpalign -g`` of the
genomes and CLI_READS reads of them (``sample_reads``, seed 1), each a
child process with ``--profile``, on the host build and on the device
build (both forced by the gate's variables; runs in the order of
CLI_ORDER): each run's wall, its stages, and the two routes' stdout,
which must be equal; for each route the medians of the wall, the build
stage and the sum of the stages, and that sum's spread.  The inputs of the
device-build window's MAX (``routes.py``).

With ``--build-cost``, the sizes in this one process instead, without
the child's start-up, whose ~0.7 s lands in a different stage on each
route: the host route (``KmerReference`` of the genomes, the CLI's
``db_build``, then its ``auto`` probe table) against the device route
(``from_device_build``, the CLI's ``db_build_device``, and its table),
COST_ITERS calls of each in turn, by their medians and spreads.  Before
them, at the smallest size, the host route and a batch of COST_READS
reads aligned on its table warm what both routes run; the device route's
first call after that, less its median there, is the one-time cost only
that route pays (the first launches of its own kernels, its first
allocations), charged to every size's device route.  The host route's
own one-time costs are not charged, so the device route's side is the
dearer one.  The inputs of the window's MIN: the least size from which
the device route is no slower.

The last line is one JSON object of every number; ``profile`` returns it
with each size's build product.  Exits 1 where CUDA is absent unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from shotgun_tpu_torch.aligner import PseudoAlignment
from shotgun_tpu_torch.index.device_build import _compute, _fetch, _host_prep, _upload
from shotgun_tpu_torch.reference import KmerReference
from shotgun_tpu_torch.tools.profile_align import table_bytes, timed_s
from shotgun_tpu_torch.utils.device import tool_device
from shotgun_tpu_torch.utils.profiling import parse_report
from shotgun_tpu_torch.utils.synth import (
    sample_reads,
    synth_genomes,
    synth_reads,
    write_workload,
)

K = 31
ITERS = 3
READ_LEN = 150
#: ``--cli``: reads a run; the routes in the order they run; each route's
#: gate variables (every other gate variable is cleared)
CLI_READS = 131_072
CLI_ORDER = ("host", "device", "device", "host")
#: ``--build-cost``: calls of each route a size; reads of the warm-up batch
COST_ITERS = 7
COST_READS = 65_536
#: the top-level stages both routes run beside their build (the wall less
#: the child's start-up); ``stages_s`` is their sum with the build's
CLI_STAGES = ("fasta_parse", "table_build", "stream_open", "stream_align", "summary")
CLI_ENV = {"host": {"SHOTGUN_TPU_DEVICE_BUILD": "0"},
           "device": {"SHOTGUN_TPU_DEVICE_BUILD_MIN": "0",
                      "SHOTGUN_TPU_DEVICE_BUILD_MAX": str(1 << 62)}}
GATE_ENV = ("SHOTGUN_TPU_PROBE", "SHOTGUN_TPU_DEVICE_BUILD",
            "SHOTGUN_TPU_DEVICE_BUILD_MIN", "SHOTGUN_TPU_DEVICE_BUILD_MAX")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_genomes(mbp: float):
    """The JAX tool's genomes of ``mbp`` Mbp, from ``default_rng(0)``."""
    n_rec = 8 if mbp >= 8 else 5
    return synth_genomes(np.random.default_rng(0), n_rec, int(mbp * 1_000_000) // n_rec)


def profile(mbp: float, device: torch.device, log: Callable[[str], None] = print) -> dict:
    """Every timing of the module doc at ``mbp``, and under ``"built"``
    the last iteration's build product (``device_build_tables``' dict
    without ``num_records``, ``num_windows`` and ``prep_s``)."""
    genomes = make_genomes(mbp)
    g, r = int(genomes.codes.size), genomes.num_records
    _host_prep(genomes)  # warm pages and the native library
    t0 = time.perf_counter()
    prep = _host_prep(genomes)
    prep_s = time.perf_counter() - t0
    if prep is None:
        raise RuntimeError("the device build refused the genomes' N runs")
    codes2, runs = prep
    log(f"[{mbp:g} Mbp] host prep: {prep_s:.3f} s ({codes2.nbytes / 1e6:.1f} MB)")
    res = {"mbp": g / 1e6, "records": r, "host_prep_s": prep_s, "iters": []}

    if _compute(g, r, K, *_upload(genomes, codes2, runs, device)) is None:  # warm
        raise RuntimeError("the device build refused the genomes")
    for it in range(ITERS):
        fresh = codes2.copy()
        up, t_up = timed_s(lambda: _upload(genomes, fresh, runs, device), device)
        computed, t_run = timed_s(lambda: _compute(g, r, K, *up), device)
        built, t_fetch = timed_s(lambda: _fetch(computed, r), device)
        total = prep_s + t_up + t_run + t_fetch
        res["iters"].append({"upload_s": t_up, "compute_s": t_run, "fetch_s": t_fetch,
                             "total_s": total, "mbp_per_s": g / 1e6 / total})
        log(f"  iter{it}: prep {prep_s:.3f} upload {t_up:.3f} compute {t_run:.3f} "
            f"fetch {t_fetch:.3f} -> {total:.3f} s ({g / 1e6 / total:.1f} Mbp/s)  "
            f"u={built['num_kmers']} sets={built['num_sets']}")

    KmerReference.from_device_build(genomes, K, device)
    base = _peak_start(device)
    ref, dt = timed_s(lambda: KmerReference.from_device_build(genomes, K, device),
                      device)
    build_peak = _peaks(device, base)
    tab, table_s = timed_s(lambda: ref.device_probe_tables(device), device)
    peak = _peaks(device, base)
    res.update(from_device_build_s=dt, from_device_build_mbp_per_s=g / 1e6 / dt,
               num_kmers=int(ref.index.num_kmers), num_sets=int(ref.index.num_sets),
               table_method=ref.probe_method(), table_s=table_s,
               table_bytes=table_bytes(tab), build_peak=build_peak, peak=peak)
    log(f"  from_device_build warm: {dt:.3f} s ({g / 1e6 / dt:.1f} Mbp/s, "
        f"{ref.index.num_kmers} k-mers, {ref.index.num_sets} sets), peak {build_peak}; "
        f"{res['table_method']} table {res['table_bytes']} B in {table_s:.3f} s, "
        f"peak with it {peak}")
    return dict(res, built=built)


def _peak_start(device: torch.device) -> Optional[int]:
    """On CUDA: the peak counters reset, and the bytes allocated now."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _peaks(device: torch.device, base: Optional[int]) -> Optional[dict]:
    """On CUDA: the peak bytes allocated and reserved since ``_peak_start``,
    and those allocated above ``base``."""
    if device.type != "cuda":
        return None
    alloc = torch.cuda.max_memory_allocated(device)
    return {"allocated": alloc, "reserved": torch.cuda.max_memory_reserved(device),
            "base": base, "above_base": alloc - base}


def cli_walls(mbp: float, device: torch.device, log: Callable[[str], None] = print) -> dict:
    """``--cli`` at ``mbp`` (see the module doc)."""
    genomes = make_genomes(mbp)
    work = sample_reads(np.random.default_rng(1), genomes, CLI_READS, READ_LEN)
    res: dict = {"mbp": genomes.codes.size / 1e6, "reads": CLI_READS, "runs": []}
    stdout = {}
    with tempfile.TemporaryDirectory() as tmp:
        fa, fq = os.path.join(tmp, "g.fa"), os.path.join(tmp, "r.fq")
        write_workload(work, fa, fq)
        del work
        for route in CLI_ORDER:
            env = {n: v for n, v in os.environ.items() if n not in GATE_ENV}
            env.update(CLI_ENV[route], SHOTGUN_TPU_TORCH_DEVICE=device.type)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "shotgun_tpu_torch", "-t", "dumpalign", "-g", fa,
                 "-k", str(K), "--reads", fq, "--profile"],
                env=env, cwd=REPO, capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"{route} route exited {proc.returncode}: "
                                   f"{proc.stderr[-2000:]}")
            stages = parse_report(proc.stderr)
            build = "db_build_device" if route == "device" else "db_build"
            if build not in stages:
                raise RuntimeError(f"the {route} route ran the stages {stages}")
            if stdout.setdefault(route, proc.stdout) != proc.stdout:
                raise RuntimeError(f"two {route} runs printed different summaries")
            res["runs"].append({"route": route, "wall_s": wall, "stages": stages})
            log(f"[{mbp:g} Mbp] CLI dumpalign -g, {route} build: wall {wall:.3f} s, "
                f"{build} {stages[build]:.3f} s, stages {stages}")
    if stdout["host"] != stdout["device"]:
        raise RuntimeError(f"at {mbp:g} Mbp the host and the device build's summaries differ")
    for route in CLI_ENV:
        runs = [r for r in res["runs"] if r["route"] == route]
        build = "db_build_device" if route == "device" else "db_build"
        sums = [sum(r["stages"][n] for n in (build,) + CLI_STAGES) for r in runs]
        res[route] = {"wall_s": statistics.median(r["wall_s"] for r in runs),
                      "build_s": statistics.median(r["stages"][build] for r in runs),
                      "stages_s": statistics.median(sums),
                      "stages_spread_s": max(sums) - min(sums)}
    log(f"[{mbp:g} Mbp] medians: host {res['host']}, device {res['device']}; "
        "summaries equal")
    return res


def _host_route(genomes, device: torch.device) -> KmerReference:
    ref = KmerReference(K, genomes, device=device)
    ref.device_probe_tables(device)
    return ref


def _device_route(genomes, device: torch.device) -> KmerReference:
    ref = KmerReference.from_device_build(genomes, K, device)
    if ref is None:
        raise RuntimeError("the device build refused the genomes")
    ref.device_probe_tables(device)
    return ref


def build_cost(mbps: List[float], device: torch.device,
               log: Callable[[str], None] = print) -> dict:
    """``--build-cost`` at the sizes ``mbps`` (see the module doc)."""
    sizes = sorted(mbps)
    first = make_genomes(sizes[0])
    ref = _host_route(first, device)
    reads = synth_reads(np.random.default_rng(1), first, COST_READS, READ_LEN)
    PseudoAlignment(ref, device).align_packed_reads(reads, 1, 1, store_reads=False)
    del ref, reads
    _, cold_s = timed_s(lambda: _device_route(first, device), device)
    res: dict = {"iters": COST_ITERS, "cold_s": cold_s, "sizes": []}
    for mbp in sizes:
        genomes = make_genomes(mbp)
        times: dict = {"host": [], "device": []}
        for _ in range(COST_ITERS):
            for route, fn in (("host", _host_route), ("device", _device_route)):
                times[route].append(timed_s(lambda: fn(genomes, device), device)[1])
        size = {"mbp": genomes.codes.size / 1e6,
                **{f"{route}_s": statistics.median(t) for route, t in times.items()},
                **{f"{route}_spread_s": max(t) - min(t) for route, t in times.items()},
                "runs": times}
        if not res["sizes"]:
            res["once_s"] = cold_s - size["device_s"]
        size["device_once_s"] = size["device_s"] + res["once_s"]
        res["sizes"].append(size)
        log(f"[{mbp:g} Mbp] host route {size['host_s']:.4f} s (spread "
            f"{size['host_spread_s']:.4f}), device route {size['device_s']:.4f} s (spread "
            f"{size['device_spread_s']:.4f}), with its one-time "
            f"{res['once_s']:.4f} s {size['device_once_s']:.4f} s")
    ok = [s["device_once_s"] <= s["host_s"] for s in res["sizes"]]
    res["device_no_slower_from_mbp"] = next(
        (s["mbp"] for i, s in enumerate(res["sizes"]) if all(ok[i:])), None)
    log(f"first device build {cold_s:.4f} s, one-time cost {res['once_s']:.4f} s; the "
        f"device route is no slower from {res['device_no_slower_from_mbp']} Mbp")
    return res


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mbp", nargs="*", type=float, default=[1, 32])
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default $SHOTGUN_TPU_TORCH_DEVICE or cuda)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--cli", action="store_true",
                      help="time the CLI's dumpalign -g on the host and the device build")
    mode.add_argument("--build-cost", action="store_true",
                      help="time the host and the device route's build and table in "
                           "this process")
    args = ap.parse_args(argv)
    device = tool_device(args.device, "profile_devbuild")
    out = {"device": str(device), "timer": "host clock up to a device synchronisation",
           "k": K, "sizes": []}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    if args.build_cost:
        out["build_cost"] = build_cost(args.mbp, device, lambda msg: print(msg, flush=True))
        print(json.dumps(out), flush=True)
        return out
    for mbp in args.mbp:
        log = lambda msg: print(msg, flush=True)  # noqa: E731
        if args.cli:
            out["sizes"].append(cli_walls(mbp, device, log))
            continue
        res = profile(mbp, device, log)
        res.pop("built")
        out["sizes"].append(res)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
