"""No run loads JAX or the JAX package, and the plain reference stands
apart from the program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from conftest import REPO

#: top-level names compared whole: the port's name begins with the JAX
#: package's, and is no match for it
FORBIDDEN = {"jax", "jaxlib", "flax", "shotgun_tpu"}
#: the benchmark's modules that must not reach the program: the reference,
#: the inputs it shares with the program, and the frozen arithmetic
STANDALONE = ("reference", "gen", "yardstick")

RUN_TINY = """
import json, sys, torch
sys.path.insert(0, {repo!r})
from shotbench.harness import run_cell
res = run_cell({root!r}, {cell!r}, 2**31 + 3, 0.2, {trace}, torch.device("cpu"), 0.0)
assert res["correct"], res
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell,trace", [("tiny.deep", True), ("tiny.oneshot", False)])
def test_run_loads_no_jax(tiny_root, cell, trace):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SHOTGUN_TPU")}
    proc = subprocess.run(
        [sys.executable, "-c", RUN_TINY.format(repo=REPO, root=tiny_root, cell=cell,
                                              trace=trace)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "shotgun_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_window_check_names_forbidden_modules(tiny_root, monkeypatch):
    import torch

    from shotbench import harness

    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    with pytest.raises(harness.ForbiddenModules, match="jax"):
        harness.run_cell(tiny_root, "tiny.deep", 1, 0.1, False, torch.device("cpu"), 0.0)


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("module", STANDALONE)
def test_reference_imports_nothing_of_the_program(module):
    names = set(_imports(os.path.join(REPO, "shotbench", f"{module}.py")))
    assert names <= {"__future__", "json", "os", "math", "statistics", "dataclasses",
                     "typing", "numpy", "torch"}, names


def test_reference_runs_with_the_program_unimportable():
    code = f"""
import sys
for name in ("shotgun_tpu_torch", "shotgun_tpu", "jax"):
    sys.modules[name] = None
sys.path.insert(0, {REPO!r})
import numpy as np, torch
from shotbench import gen, reference
cfg = dict(genomes=4, species=2, strains_per_species=2, genome_len=5000,
           strain_mutation_rate=0.01, read_len=150)
tr = dict(reads_per_sample=500, error_rate=0.005,
          abundance=dict(lognormal_mu=1.0, lognormal_sigma=2.0),
          quality=dict(phred_start=38, phred_end=30, low_share=0.02, low_min=2,
                       low_max=15, offset=33))
cpu = torch.device("cpu")
g = gen.make_genomes(cfg, 5, cpu)
s = gen.make_sample(g, cfg, tr, 5, 0, cpu)
index = reference.build_index(g.codes, g.offsets, 31)
out = reference.summarize(index, s.codes, s.qual, 31, reference.Gates(), g.descriptions, cpu)
assert sum(out["Statistics"].values()) == 500, out
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
