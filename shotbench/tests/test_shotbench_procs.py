"""A cell over several cards, as processes over gloo on the CPU: a
configuration with a ``mesh``, added by files alone in a copy, runs as
one process a card and reads correct; a process that raises, or a run
that passes its deadline, ends the whole run with a code other than 0."""

from __future__ import annotations

import json
import os
import sys
import time

import pytest

from conftest import REPO
from shotbench import procs
from shotbench.cells import load_cell

MESH_CELL = "tinymesh.shallow"


def _add_mesh_cell(root: str) -> str:
    """A configuration with ``"mesh": {"data": 1, "table": 2}`` and a
    two-chip cell on it, by files and entries alone."""
    with open(os.path.join(root, "shotbench", "configs", "tiny_shallow_cfg.json")) as fh:
        cfg = dict(json.load(fh), name="tinymesh_cfg", mesh={"data": 1, "table": 2})
    with open(os.path.join(root, "shotbench", "configs", "tinymesh_cfg.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append(dict(bench["configs"][1], name="tinymesh_cfg",
                                 file="shotbench/configs/tinymesh_cfg.json"))
    bench["workloads"].append(dict(name=MESH_CELL, config="tinymesh_cfg",
                                   traffic="tiny_shallow", chips=2,
                                   why="the table axis over two processes"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "reads_per_s":
            m["workloads"].append(MESH_CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return MESH_CELL


@pytest.fixture(scope="module")
def mesh_root(tmp_path_factory):
    from conftest import make_copy

    root = make_copy(str(tmp_path_factory.mktemp("mesh")))
    _add_mesh_cell(root)
    return root


@pytest.fixture
def cpu_children(monkeypatch):
    """The children's program (this repository's, beside the copy's
    benchmark) on the CPU, with the probe routes of a plain run."""
    for name in list(os.environ):
        if name.startswith("SHOTGUN_TPU"):
            monkeypatch.delenv(name)
    monkeypatch.setenv("SHOTGUN_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", REPO)


def _argv(cell: str, seed: int, trace: int, seconds: float = 0.5):
    return ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace), "--t0", repr(time.perf_counter()), "--device", "cpu"]


def _child(root: str):
    return [sys.executable, os.path.join(root, "shotbench", "run.py")]


def test_mesh_must_cover_the_chips(mesh_root, tmp_path):
    assert load_cell(mesh_root, MESH_CELL).mesh == {"data": 1, "table": 2}
    assert load_cell(mesh_root, "tiny.shallow").mesh is None
    with open(os.path.join(mesh_root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    next(w for w in bench["workloads"] if w["name"] == MESH_CELL)["chips"] = 4
    os.symlink(os.path.join(mesh_root, "shotbench"), tmp_path / "shotbench")
    with open(tmp_path / "BENCHMARK.json", "w") as fh:
        json.dump(bench, fh)
    with pytest.raises(ValueError, match="does not cover"):
        load_cell(str(tmp_path), MESH_CELL)


@pytest.mark.parametrize("trace", [0, 1])
def test_mesh_cell_runs_as_two_processes(mesh_root, cpu_children, trace):
    t0 = time.monotonic()
    rc, line = procs.launch(_child(mesh_root), _argv(MESH_CELL, 2**31 + 21, trace), 2,
                            deadline_s=300)
    assert rc == 0 and line is not None
    res = json.loads(line)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 2
    assert res["failed"] == 0 and res["attempted"] >= 4
    assert res["attempted"] % 2 == 0  # every process answers every request
    assert list(res)[-1] == "checks"
    if trace:
        cards = res["device"]["cards"]
        assert [c["card"] for c in cards] == [0, 1]
        assert res["device"]["busy_s"] == pytest.approx(
            sum(c["busy_s"] for c in cards) / 2)
        assert "breakdown" in res and res["device"]["window_s"] > 0
    else:
        assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
        assert res["metrics"]["setup_s"]["value"] > 0
    assert time.monotonic() - t0 < 300


FAULTY = """
import sys
sys.path.insert(0, {root!r})
import torch.distributed as dist
import shotgun_tpu_torch.cli as cli

real = cli.create_alignment_from_reference


def broken(*args, **kwargs):
    if dist.get_rank() == 1:
        raise RuntimeError("planted: process 1 fails")
    return real(*args, **kwargs)


cli.create_alignment_from_reference = broken
from shotbench import run
sys.exit(run.main())
"""


def test_one_process_raising_fails_the_run(mesh_root, cpu_children, tmp_path, capfd):
    """Process 1 raises in its first request while process 0 waits in a
    collective: the run ends, with that failure's code, well within its
    limit."""
    script = tmp_path / "faulty.py"
    script.write_text(FAULTY.format(root=mesh_root))
    t0 = time.monotonic()
    rc, line = procs.launch([sys.executable, str(script)],
                            _argv(MESH_CELL, 2**31 + 22, 0), 2, deadline_s=240)
    assert rc not in (0, 124) and line is None
    assert time.monotonic() - t0 < 200
    err = capfd.readouterr().err
    assert "planted: process 1 fails" in err and "were ended" in err


def test_a_run_past_its_deadline_is_ended(tmp_path):
    t0 = time.monotonic()
    rc, line = procs.launch([sys.executable, "-c", "import time; time.sleep(600)"],
                            [], 2, deadline_s=2.0)
    assert rc == 124 and line is None
    assert time.monotonic() - t0 < 30
