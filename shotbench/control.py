"""The control of the check that decides ``correct``: the plain reference
put in the program's place with one guarantee broken, which the check must
find.

    python3 shotbench/control.py --workload <cell> --seed <n> [<n> ...]

The configurations state an exact classification: every k-mer is
compared on all of its bases.  At k <= 31 the control compares only the
62-bit key's low 32-bit word (the last 16 bases), as a probe that matches
the low word of a table row alone would; past 31 bases only the most
significant of the key's words (the first 31 bases), as a probe that
compares one word of a multi-word key: the nearest coarser key.  For each seed it makes
the cell's inputs at the cell's own size, as a run does, computes each
sample file's summary both ways and prints, as one JSON line, the numbers
the run's check compares with their limits; the control has to exceed a
limit.  Needs a CUDA card; runs no window and none of the program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from shotbench import reference  # noqa: E402
from shotbench.cells import load_cell  # noqa: E402
from shotbench.harness import LIMITS, Inputs, compare, expected  # noqa: E402


def control_numbers(root: str, name: str, seed: int, device: torch.device) -> dict:
    """The check's numbers for the control's answers on ``seed``: one
    answer per sample file, against the exact reference's."""
    cell = load_cell(root, name)
    with tempfile.TemporaryDirectory(prefix="shotbench-control-") as tmp:
        inputs = Inputs(cell, seed, device, tmp)
    want = expected(inputs)
    got = expected(inputs, key_map=reference.control_key(inputs.k))
    files = sorted(got)
    numbers = compare([got[f] for f in files], files, want)
    return {"workload": name, "seed": seed, "numbers": numbers,
            "exceeds_a_limit": any(numbers[n] > LIMITS[n] for n in LIMITS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seed:
        print(json.dumps(control_numbers(ROOT, args.workload, seed,
                                         torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
