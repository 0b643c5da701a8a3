"""CPU tests of the cell ``marine35.deep`` (the CAMI II marine genomes at
k = 35): the cell as ``BENCHMARK.json`` gives it, the readers of its two
per-layer metrics, and a tiny copy of its configuration on the resident
path, whose device-built database at k = 35 answers as the plain
reference does, and whose traced run reports the sort join's span."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import REPO
from shotbench import reference
from shotbench.cells import load_cell
from shotbench.harness import Inputs, Request, RunData, run_cell
from shotbench.trace import Trace
from shotbench.yardstick import bound_s

CPU = torch.device("cpu")
CELL = "marine35.deep"
#: the resident per-layer metrics the cell shares with marine.deep, and its own
SHARED = ("fill_reads_per_s", "device_ms_per_batch", "device_idle_share", "fill_wait_share",
          "fill_stream_reads_per_s", "stage_ms_per_batch", "enqueue_ms_per_batch",
          "sample_fixed_ms")
OWN = ("encode_words_roofline", "sort_join_ms_per_batch")
GATES = {"none": {}, "mkq": {"min_kmer_quality": 63}}


def test_cell_as_declared():
    cell = load_cell(REPO, CELL)
    assert cell.chips == 1 and cell.mesh is None
    assert cell.config["k"] == 35 and cell.traffic["kind"] == "resident"
    assert cell.traffic["reads_per_sample"] == 2_097_152
    assert {m.name for m in cell.end_to_end} == {"reads_per_s", "setup_s"}
    assert {m.name for m in cell.per_layer} == set(SHARED + OWN)
    deep = load_cell(REPO, "marine.deep")
    assert {key: v for key, v in cell.config.items()
            if key not in ("name", "source", "deployment", "architecture", "k",
                           "reduced", "assumed")} == {
        key: v for key, v in deep.config.items()
        if key not in ("name", "source", "deployment", "k", "reduced", "assumed")}
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for m in bench["per_layer"]:
        if m["name"] in ("encode_window_roofline", "hash_probe_roofline"):
            assert CELL not in m["workloads"]
        if m["name"] in OWN:
            assert m["workloads"] == [CELL] and m["moves"] == "reads_per_s"


def _readers():
    return {m.name: m.read for m in load_cell(REPO, CELL).per_layer if m.name in OWN}


def _trace(kernels) -> Trace:
    return Trace(window_s=50.0, busy_s=40.0, kernel_busy_s=39.0, kernels=kernels,
                 idle_by_host={})


def test_readers_read_nothing_without_their_inputs():
    for name, read in _readers().items():
        assert read(RunData(kind="resident", setup_s=10.0)) is None, name
    run = RunData(kind="resident", setup_s=10.0, spans={"enqueue": (2.0, 100)},
                  trace=_trace({"void encode_window_kernel<true, false>": [1e-4] * 4}),
                  launches={"encode_window": [10**6] * 4})
    for name, read in _readers().items():
        assert read(run) is None, name


def test_readers_give_their_formula():
    nbytes = 310_000_000
    times = [2.5e-4, 2.6e-4, 2.4e-4]
    run = RunData(kind="resident", setup_s=10.0, spans={"sort_join_device": (12.0, 96)},
                  trace=_trace({"void (anonymous namespace)::encode_words_kernel<false>(...)":
                                times}),
                  launches={"encode_words": [nbytes] * 3})
    run.requests = [Request(0, 2_097_152, 32, 5.0, "{}")] * 3
    readers = _readers()
    assert readers["sort_join_ms_per_batch"](run) == pytest.approx(125.0, rel=1e-12)
    assert readers["encode_words_roofline"](run) == pytest.approx(
        100.0 * bound_s(3 * nbytes) / sum(times), rel=1e-12)
    run.launches = {"encode_words": [nbytes] * 4}  # the trace lost a launch
    assert readers["encode_words_roofline"](run) is None


def _tiny_root(dest: str) -> str:
    """A copy with a tiny ``marine35.deep``: its configuration with 4
    genomes of 30 kbp, its traffic with 6,000 reads a sample, its metrics
    listed for it."""
    from conftest import make_copy

    root = make_copy(dest)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    with open(os.path.join(root, c["file"])) as fh:
        cfg = dict(json.load(fh), genomes=4, species=4, genome_len=30_000)
    with open(os.path.join(root, "shotbench", "configs", "tiny35_deep_cfg.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(root, "shotbench", "traffic", f"{w['traffic']}.json")) as fh:
        tr = dict(json.load(fh), reads_per_sample=6000)
    with open(os.path.join(root, "shotbench", "traffic", "tiny35_deep.json"), "w") as fh:
        json.dump(tr, fh)
    bench["configs"].append(dict(c, name="tiny35_deep_cfg",
                                 file="shotbench/configs/tiny35_deep_cfg.json"))
    bench["workloads"].append(dict(w, name="tiny35.deep", config="tiny35_deep_cfg",
                                   traffic="tiny35_deep"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny35.deep")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root


@pytest.fixture(scope="module")
def tiny35_root(tmp_path_factory):
    return _tiny_root(str(tmp_path_factory.mktemp("marine35")))


@pytest.mark.parametrize("gates", sorted(GATES))
def test_resident_path_at_k35_matches_reference(tiny35_root, tmp_path, monkeypatch, gates):
    """``from_device_build`` at k = 35, then each sample through
    ``cli.create_alignment_from_reference`` and ``get_summary()``: the
    plain reference's summary, without gates and with the k-mer quality
    gate."""
    from shotgun_tpu_torch import cli
    from shotgun_tpu_torch.io.packing import GenomeArrays
    from shotgun_tpu_torch.reference import KmerReference

    monkeypatch.delenv("SHOTGUN_TPU_PROBE", raising=False)
    inp = Inputs(load_cell(tiny35_root, "tiny35.deep"), 2**31 + 350, CPU, str(tmp_path))
    assert inp.k == 35
    g = reference.Gates(**dict(dict(m=1, p=1), **GATES[gates]))
    ref = KmerReference.from_device_build(
        GenomeArrays(inp.descriptions, inp.codes, inp.offsets), inp.k, CPU)
    assert ref is not None and len(ref.sort_columns()[0]) == 2
    index = reference.build_index(torch.from_numpy(inp.codes), inp.offsets, inp.k)
    for f, path in enumerate(inp.paths):
        got = cli.create_alignment_from_reference(
            ref, path, CPU, g.m, g.p, g.min_read_quality, g.min_kmer_quality,
            g.max_genomes).get_summary()
        want = reference.summarize(index, inp.samples[f].codes, inp.samples[f].qual,
                                   inp.k, g, inp.descriptions, CPU)
        assert reference.summary_text(got) == reference.summary_text(want)
        assert want["Statistics"]["unique_mapped_reads"] > 0
        if gates == "mkq":
            assert want["Statistics"]["filtered_quality_kmers"] > 0


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_correct(tiny35_root, trace):
    """The tiny copy of the cell through the harness on the CPU: correct;
    traced, the sort join's milliseconds a batch are reported (the kernel
    roofline needs a card's trace)."""
    res = run_cell(tiny35_root, "tiny35.deep", 2**31 + 35_035, 0.3, trace, CPU, 0.0)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    if trace:
        assert res["metrics"]["sort_join_ms_per_batch"]["value"] > 0
        assert "encode_words_roofline" not in res["metrics"]
    else:
        assert {"reads_per_s", "setup_s"} <= set(res["metrics"])
