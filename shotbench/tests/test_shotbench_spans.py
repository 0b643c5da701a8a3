"""CPU tests of the readers of the program's stream spans: each metric's
value on a hand-built ``RunData`` is its formula's, it reads nothing
where its span is missing (as on a program without the span), the cells
list it, and a traced run of a tiny cell on the CPU reports it."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import REPO
from shotbench.cells import load_cell
from shotbench.harness import Request, RunData, run_cell

CPU = torch.device("cpu")
RESIDENT = ("fill_wait_share", "fill_stream_reads_per_s", "stage_ms_per_batch",
            "enqueue_ms_per_batch", "sample_fixed_ms")
ONESHOT = ("db_host_prep_ms.oneshot",)
#: (seconds, calls) of each span of the hand-built run
SPANS = {"fill_wait": (12.5, 1100), "fill": (40.0, 1100), "stage": (3.3, 1000),
         "enqueue": (2.2, 1000), "stream_open": (4.0, 20), "table_build": (0.02, 20),
         "validate": (0.01, 20), "carry_fetch": (1.5, 20), "host_merge": (0.03, 20),
         "summary": (0.06, 20), "stream_align": (48.0, 20), "db_host_prep": (0.9, 18)}
#: the span each reader needs, and its value on the hand-built run
#: (20 samples of 2,097,152 reads in a 50 s window)
WANT = {
    "fill_wait_share": (("fill_wait",), 100.0 * 12.5 / 50.0),
    "fill_stream_reads_per_s": (("fill",), 20 * 2_097_152 / 40.0),
    "stage_ms_per_batch": (("stage",), 3.3),
    "enqueue_ms_per_batch": (("enqueue",), 2.2),
    "sample_fixed_ms": (("stream_open", "table_build", "validate", "carry_fetch",
                         "host_merge", "summary", "stream_align"),
                        1e3 * (4.0 + 0.02 + 0.01 + 1.5 + 0.03 + 0.06) / 20),
    "db_host_prep_ms.oneshot": (("db_host_prep",), 1e3 * 0.9 / 18),
}


def _readers():
    cells = {"marine.deep": RESIDENT, "strain.shallow": RESIDENT, "strain.oneshot": ONESHOT}
    out = {}
    for cell, names in cells.items():
        for m in load_cell(REPO, cell).per_layer:
            if m.name in names:
                out[m.name] = m.read
    return out


def _run(spans) -> RunData:
    run = RunData(kind="resident", setup_s=10.0, window_s=50.0, spans=dict(spans))
    run.requests = [Request(i % 2, 2_097_152, 32, 2.4, "{}") for i in range(20)]
    return run


def test_cells_list_the_span_metrics():
    for cell, names in (("marine.deep", RESIDENT), ("strain.shallow", RESIDENT),
                        ("strain.oneshot", ONESHOT)):
        got = {m.name for m in load_cell(REPO, cell).per_layer}
        assert set(names) <= got, cell
    assert not set(RESIDENT) & {m.name for m in load_cell(REPO, "strain.oneshot").per_layer}
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        entries = {m["name"]: m for m in json.load(fh)["per_layer"]}
    for name in RESIDENT + ONESHOT:
        assert entries[name]["source"] == "program_span"


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_its_formula(name):
    value = _readers()[name](_run(SPANS))
    assert value == pytest.approx(WANT[name][1], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_without_its_span(name):
    read = _readers()[name]
    for span in WANT[name][0]:
        spans = {k: v for k, v in SPANS.items() if k != span}
        assert read(_run(spans)) is None, span
    # the span names of a program without the stream's spans
    older = {k: SPANS[k] for k in ("table_build", "stream_align")}
    assert read(_run(older)) is None


def test_window_without_time_or_reads_reads_nothing():
    readers = _readers()
    run = _run(SPANS)
    run.window_s = 0.0
    assert readers["fill_wait_share"](run) is None
    run = _run(SPANS)
    run.requests = []
    assert readers["fill_stream_reads_per_s"](run) is None


@pytest.mark.parametrize("cell,names", [("tiny.shallow", RESIDENT), ("tiny.oneshot", ONESHOT)])
def test_traced_tiny_run_reports_the_span_metrics(tmp_path, monkeypatch, cell, names):
    """A copy whose span metrics also list the tiny cells: a traced CPU
    run reports each (the tiny genomes built on the device, as the
    cells' are on the card)."""
    from conftest import make_copy

    monkeypatch.setenv("SHOTGUN_TPU_DEVICE_BUILD_MIN", "0")
    root = make_copy(str(tmp_path))
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for m in bench["per_layer"]:
        if m["name"] in names:
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    res = run_cell(root, cell, 2**31 + 16, 0.3, True, CPU, 0.0)
    assert res["correct"], res["checks"]
    metrics = res["metrics"]
    assert set(names) <= set(metrics)
    for name in names:
        assert metrics[name]["value"] > 0, name
    if "fill_wait_share" in metrics:
        assert metrics["fill_wait_share"]["value"] <= 100.0
