"""The check that decides ``correct`` fails what it must: the control (the
plain reference with the key compared on its low 32-bit word alone) and
the faults a cell can have, planted in the program under a whole run."""

from __future__ import annotations

import json
import os

import pytest
import torch

from shotbench.control import control_numbers
from shotbench.harness import run_cell

CPU = torch.device("cpu")
CELLS = ["tiny.deep", "tiny.shallow", "tiny.oneshot"]


def _with_errors(root: str, cell: str, rate: float) -> str:
    """``cell``'s traffic file with reads at substitution rate ``rate``:
    at a test's size only reads with many errors tell the coarse key
    apart, since random 16-mers of a few genomes do not collide."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    path = os.path.join(root, "shotbench", "traffic", f"{w['traffic']}.json")
    with open(path) as fh:
        tr = json.load(fh)
    tr["error_rate"] = rate
    name = f"{cell}.errors"
    with open(os.path.join(root, "shotbench", "traffic", f"{w['traffic']}_errors.json"),
              "w") as fh:
        json.dump(tr, fh)
    if name not in {x["name"] for x in bench["workloads"]}:
        bench["workloads"].append(dict(w, name=name, traffic=f"{w['traffic']}_errors"))
        with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
            json.dump(bench, fh)
    return name


@pytest.mark.parametrize("seed", [11, 2**31 + 5, 3_000_000_019])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell, seed):
    name = cell if cell != "tiny.deep" else _with_errors(tiny_root, cell, 0.03)
    out = control_numbers(tiny_root, name, seed, CPU)
    assert out["exceeds_a_limit"], out
    assert out["numbers"]["mismatched_summaries"] >= 1


def _state_unchanged(monkeypatch):
    import shotgun_tpu_torch.aligner as al

    monkeypatch.setattr(al, "_fold_agg", lambda carry, agg: carry)


def _half_batch(monkeypatch):
    import shotgun_tpu_torch.aligner as al

    real = al.aggregate_batch

    def half(res, row_valid):
        keep = torch.arange(row_valid.shape[0], device=row_valid.device) < (
            row_valid.shape[0] // 2)
        return real(res, row_valid & keep)

    monkeypatch.setattr(al, "aggregate_batch", half)


def _answer_altered(monkeypatch):
    import shotgun_tpu_torch.aligner as al

    real = al.align_batch

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        mtype = res.mtype.clone()
        mtype[0] = torch.where(mtype[0] == 1, 2, 1)
        return res._replace(mtype=mtype)

    monkeypatch.setattr(al, "align_batch", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch_left_out": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    """A whole run (the look for a card skipped) with the timed path broken
    underneath comes out not correct.  The cells run on one chip, so the
    fault of an exchange between chips has no path to break."""
    FAULTS[fault](monkeypatch)
    res = run_cell(tiny_root, cell, 2**31 + 9, 0.2, False, CPU, 0.0)
    assert res["correct"] is False
    assert res["checks"]["mismatched_summaries"]["value"] >= 1
