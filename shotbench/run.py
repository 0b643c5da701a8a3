"""The benchmark of the PyTorch and CUDA port (``shotgun_tpu_torch``).

    python3 shotbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  One process is one run of one cell of
``BENCHMARK.json``: inputs from ``--seed``, set-up, warm-up, ``--seconds``
of measured work, the check of every answer against the plain reference,
then one JSON object as the last line of standard output.  With
``--trace 0`` it carries the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, read from a profiler trace of the window.  The
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.

It needs the CUDA cards the cell asks for and exits with code 2,
printing no result, without them; with code 3 when the window leaves
JAX or the JAX package loaded.  A cell whose configuration has a
``mesh`` runs as one process a card, each this command with the options
``--rank`` and the like that the run's first process (``procs.launch``)
adds; that process prints the result line of process 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from shotbench import procs  # noqa: E402
from shotbench.cells import load_cell  # noqa: E402
from shotbench.harness import ForbiddenModules, forbidden_loaded, run_cell  # noqa: E402


def card_line() -> str:
    """The card's name and power limit by ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        out = f"not read ({exc})"
    return f"card (name, power.limit): {out}"


def report(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a process of a multi-process run, as procs.launch starts it
    for name, kind in (("--rank", int), ("--world", int), ("--store-port", int),
                       ("--tmp", str), ("--t0", float)):
        ap.add_argument(name, type=kind, help=argparse.SUPPRESS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    cell = load_cell(ROOT, args.workload)
    if args.rank is not None:
        return process_main(args, cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"shotbench: cell {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(card_line(), file=sys.stderr, flush=True)
    if cell.mesh is not None:
        return launch_main(args, cell.chips)
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0), T_START)
    except ForbiddenModules as exc:
        print(f"shotbench: {exc}", file=sys.stderr)
        return 3
    report(result)
    return 0


def launch_main(args, world: int) -> int:
    """The run's first process: ``world`` processes of this command, then
    process 0's result line; their failure's code, or 3 when this process
    holds JAX or the JAX package."""
    argv = ["--workload", args.workload, "--seed", str(args.seed), "--seconds",
            str(args.seconds), "--trace", str(args.trace), "--t0", repr(T_START),
            "--device", args.device]
    rc, line = procs.launch([sys.executable, os.path.abspath(__file__)], argv, world)
    if rc != 0:
        return rc
    bad = forbidden_loaded()
    if bad:
        print(f"shotbench: loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    report(json.loads(line))
    return 0


def process_main(args, cell) -> int:
    """Process ``args.rank`` of a multi-process run, on card ``rank`` (or
    on the CPU, for the tests); process 0 prints the result line."""
    if args.device == "cuda":
        if torch.cuda.device_count() < args.world:
            print(f"shotbench: process {args.rank} finds "
                  f"{torch.cuda.device_count()} CUDA card(s), not {args.world}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", args.rank)
    else:
        device = torch.device("cpu")
    place = procs.join(args.rank, args.world, args.store_port, args.tmp, cell.mesh)
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), device, args.t0, place)
    except ForbiddenModules as exc:
        print(f"shotbench: process {args.rank}: {exc}", file=sys.stderr)
        return 3
    if result is not None:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
