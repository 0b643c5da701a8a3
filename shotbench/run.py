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
JAX or the JAX package loaded.
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

from shotbench.cells import load_cell  # noqa: E402
from shotbench.harness import ForbiddenModules, run_cell  # noqa: E402


def card_line() -> str:
    """The card's name and power limit by ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        out = f"not read ({exc})"
    return f"card (name, power.limit): {out}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"shotbench: cell {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(card_line(), file=sys.stderr, flush=True)
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0), T_START)
    except ForbiddenModules as exc:
        print(f"shotbench: {exc}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
