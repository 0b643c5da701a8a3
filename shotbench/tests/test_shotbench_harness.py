"""CPU tests of the benchmark's harness: seeded inputs, cells found by
name, the frozen byte counts, the plain reference against the port's CPU
route, and the refusal to run without a card."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO
from shotbench import gen, reference, yardstick
from shotbench.cells import load_cell
from shotbench.harness import check, row_stride, run_cell

CPU = torch.device("cpu")


def _inputs(root, cell, seed, tmp):
    from shotbench.harness import Inputs

    return Inputs(load_cell(root, cell), seed, CPU, str(tmp))


def _digest(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.mark.parametrize("cell", ["tiny.deep", "tiny.shallow"])
def test_inputs_follow_the_seed(tiny_root, tmp_path, cell):
    seed = 2**31 + 12345
    runs = []
    for i, s in enumerate((seed, seed, seed + 1)):
        d = tmp_path / str(i)
        d.mkdir()
        runs.append(_inputs(tiny_root, cell, s, d))
    a, b, c = runs
    assert np.array_equal(a.codes, b.codes)
    assert [_digest(p) for p in a.paths] == [_digest(p) for p in b.paths]
    assert not np.array_equal(a.codes, c.codes)
    assert a.samples[0].counts.sum() == a.n_reads == c.samples[0].counts.sum()
    assert not np.array_equal(a.samples[0].codes, c.samples[0].codes)


def test_fastq_and_fasta_writers(tiny_root, tmp_path):
    from shotgun_tpu_torch.io.data_file import FASTAFile, FASTAQFile

    inp = _inputs(tiny_root, "tiny.shallow", 7, tmp_path)
    recs = list(FASTAQFile(inp.paths[1]).container)
    s = inp.samples[1]
    assert len(recs) == s.codes.shape[0]
    assert recs[3]["sequence"] == bytes(gen.ACGT.numpy()[s.codes[3]]).decode()
    assert recs[3]["quality_sequence"] == bytes(s.qual[3]).decode()
    assert recs[3].identifier == "s001r000000003"
    fasta = str(tmp_path / "g.fa")
    gen.write_fasta(fasta, gen.Genomes(inp.descriptions, torch.from_numpy(inp.codes),
                                       inp.offsets))
    arrays = FASTAFile(fasta).container.to_genome_arrays()
    assert arrays.descriptions == inp.descriptions
    assert np.array_equal(arrays.codes, inp.codes)


def test_quality_profile_is_legal_phred33():
    from shotgun_tpu_torch.constants import QUALITY_CHAR_MASK

    q = dict(phred_start=38, phred_end=30, offset=33)
    prof = gen.quality_profile(150, q)
    assert int(prof[0]) == 38 and int(prof[-1]) == 30
    assert all(QUALITY_CHAR_MASK[v + 33] for v in range(2, 41))


def test_cell_added_by_files_alone(tiny_root, tmp_path):
    """A new configuration, traffic mix, metric reader and cell, as files
    and entries only, run with no edit of an existing file."""
    root = str(tmp_path)
    from conftest import make_copy

    make_copy(root)
    with open(os.path.join(root, "shotbench", "configs", "tiny_deep_cfg.json")) as fh:
        cfg = dict(json.load(fh), name="added_cfg", genomes=3, species=3)
    with open(os.path.join(root, "shotbench", "configs", "added_cfg.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(root, "shotbench", "traffic", "tiny_shallow.json")) as fh:
        tr = dict(json.load(fh), reads_per_sample=1500, sample_files=2,
                  gates={"m": 1, "p": 1, "max_genomes": 1})
    with open(os.path.join(root, "shotbench", "traffic", "added_mix.json"), "w") as fh:
        json.dump(tr, fh)
    with open(os.path.join(root, "shotbench", "metrics", "added_requests.py"), "w") as fh:
        fh.write("def read(run):\n    return float(len(run.requests))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append(dict(bench["configs"][0], name="added_cfg",
                                 file="shotbench/configs/added_cfg.json"))
    bench["workloads"].append(dict(name="added.cell", config="added_cfg",
                                   traffic="added_mix", chips=1, why="added"))
    bench["end_to_end"].append(dict(name="added_requests", unit="requests",
                                    better="higher", bound=0.25, source="host_clock",
                                    workloads=["added.cell"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    res = run_cell(root, "added.cell", 99, 0.3, False, CPU, 0.0)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"added_requests", "setup_s"}
    assert res["metrics"]["added_requests"]["value"] >= 1
    assert list(res)[-1] == "checks"


def test_metric_selection(tiny_root):
    shallow = load_cell(tiny_root, "strain.shallow")
    layer = {m.name for m in load_cell(tiny_root, "strain.oneshot").per_layer}
    assert {m.name for m in shallow.end_to_end} == {"reads_per_s", "setup_s"}
    assert "sample_s_p90" in {m.name for m in shallow.per_layer}
    assert {(m.name, m.source) for m in load_cell(tiny_root, "strain.oneshot").end_to_end
            } == {("kernel_ms_per_run", "device_trace"), ("setup_s", "host_clock")}
    assert layer == {"fasta_parse_ms.oneshot", "db_build_ms.oneshot",
                     "table_build_ms.oneshot", "device_idle_share.oneshot",
                     "db_host_prep_ms.oneshot", "run_s.oneshot"}


@pytest.mark.parametrize("rows,width,sums", [(1, 40, False), (7, 40, True),
                                             (65536, 40, True), (1, 1000, False)])
def test_h1_bytes_match_port_tool(rows, width, sums):
    from shotgun_tpu_torch.tools.bench_encode import h1_bytes

    assert yardstick.h1_bytes(rows, width, 31, True, sums) == h1_bytes(rows, width, 31,
                                                                       True, sums)


@pytest.mark.parametrize("slots,buckets,stash", [(16, 1 << 10, 0), (16, 1 << 12, 3),
                                                 (4, 1 << 11, 64)])
def test_h2_bytes_match_port_tool(slots, buckets, stash):
    from shotgun_tpu_torch.ops.encode import mix32
    from shotgun_tpu_torch.tools.bench_probe import h2_bytes

    g = torch.Generator().manual_seed(slots * buckets + stash)
    table = torch.zeros((buckets, slots, 4), dtype=torch.int32)
    st = torch.zeros((stash, 4), dtype=torch.int32)
    keys = torch.randint(0, 1 << 62, (333, 130), generator=g, dtype=torch.int64)
    row_bytes = slots * 4 * table.element_size()
    assert yardstick.h2_bytes(buckets, row_bytes, stash, keys) == h2_bytes(table, st, keys)
    lo, hi = yardstick.split_key(keys)
    assert torch.equal(yardstick.mix32(lo, hi), mix32(lo, hi))


def test_busy_union_matches_port_tool():
    from shotgun_tpu_torch.tools.profile_align import device_busy_us

    events = [dict(ph="X", cat=c, ts=t, dur=d) for c, t, d in
              [("kernel", 0, 10), ("gpu_memcpy", 5, 10), ("kernel", 30, 1),
               ("cpu_op", 0, 100), ("gpu_memset", 31, 0.5), ("kernel", 40, 2)]]
    assert yardstick.device_busy_us(events) == device_busy_us(events) == 18.5


class _Profile:
    """A profile that exports the given events as its Chrome trace."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as fh:
            json.dump({"traceEvents": self.events}, fh)


def test_device_trace_of_an_untraced_window(tiny_root, tmp_path):
    from shotbench.harness import Request, RunData
    from shotbench.trace import read_device

    ev = [dict(ph="X", cat="kernel", name="a", ts=0, dur=100),
          dict(ph="X", cat="kernel", name="b", ts=50, dur=100),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=300, dur=40),
          dict(ph="X", cat="gpu_memset", name="Memset", ts=320, dur=40),
          dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=0, dur=999),
          dict(ph="i", cat="kernel", name="c", ts=500)]
    path = str(tmp_path / "device.json")
    tr = read_device(_Profile(ev), path, 2.5)
    assert not os.path.exists(path)
    assert (tr.window_s, tr.busy_s, tr.kernel_busy_s) == (2.5, 210e-6, 150e-6)
    assert tr.kernels == {"a": [100e-6], "b": [100e-6], "Memcpy HtoD": [40e-6],
                          "Memset": [40e-6]}
    read = {m.name: m.read for m in load_cell(tiny_root, "strain.oneshot").end_to_end}
    run = RunData(kind="oneshot", setup_s=1.0, window_s=2.5, trace=tr,
                  requests=[Request(0, 1, 1), Request(0, 1, 1)])
    assert read["kernel_ms_per_run"](run) == pytest.approx(0.075)
    assert read["kernel_ms_per_run"](RunData(kind="oneshot", setup_s=1.0)) is None


def test_row_stride_matches_port():
    from shotgun_tpu_torch.aligner import _lpad

    for length, k in ((150, 31), (100, 31), (5, 31), (33, 7)):
        assert row_stride(length, k) == _lpad(length, k)


def test_statistics():
    assert yardstick.nearest_rank(list(range(1, 101)), 0.9) == 90
    assert yardstick.nearest_rank([3.0], 0.9) == 3.0


ROUTES = {"auto": None, "sort": "sort", "hash16": "hash16", "hash": "hash"}
GATES = {
    "none": {},
    "quality": {"min_read_quality": 53, "min_kmer_quality": 63},
    "read_only": {"min_read_quality": 67},
    "max_genomes": {"max_genomes": 2},
    "all_p0": {"min_read_quality": 66, "min_kmer_quality": 66, "max_genomes": 3,
               "p": 0, "m": 2},
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("gates", sorted(GATES))
def test_reference_matches_port(tiny_root, tmp_path, monkeypatch, route, gates):
    """The plain reference's summary equals the port's, on a strain panel
    with shared k-mers, on each probe route, with and without gates."""
    from shotgun_tpu_torch import cli
    from shotgun_tpu_torch.io.packing import GenomeArrays
    from shotgun_tpu_torch.reference import KmerReference

    if ROUTES[route] is not None:
        monkeypatch.setenv("SHOTGUN_TPU_PROBE", ROUTES[route])
    inp = _inputs(tiny_root, "tiny.shallow", 4242, tmp_path)
    g = reference.Gates(**dict(dict(m=1, p=1), **GATES[gates]))
    ref = KmerReference(inp.k, GenomeArrays(inp.descriptions, inp.codes, inp.offsets),
                        device=CPU)
    index = reference.build_index(torch.from_numpy(inp.codes), inp.offsets, inp.k)
    stats = []
    for f, path in enumerate(inp.paths):
        got = cli.create_alignment_from_reference(
            ref, path, CPU, g.m, g.p, g.min_read_quality, g.min_kmer_quality,
            g.max_genomes).get_summary()
        want = reference.summarize(index, inp.samples[f].codes, inp.samples[f].qual,
                                   inp.k, g, inp.descriptions, CPU)
        assert reference.summary_text(got) == reference.summary_text(want)
        stats.append(want["Statistics"])
    assert all(s["ambiguous_mapped_reads"] > 0 and s["unique_mapped_reads"] > 0
               for s in stats)
    for name, gate in (("filtered_quality_reads", "min_read_quality"),
                       ("filtered_quality_kmers", "min_kmer_quality"),
                       ("filtered_hr_kmers", "max_genomes")):
        assert all((name in s) == (gate in GATES[gates]) for s in stats)
        if gate in GATES[gates] and GATES[gates][gate] > 60:
            assert all(s[name] > 0 for s in stats)
    if "max_genomes" in GATES[gates]:
        assert all(s["filtered_hr_kmers"] > 0 for s in stats)


def test_reference_matches_port_device_build(tiny_root, tmp_path):
    """The resident cells' route: the database built by the device build."""
    from shotgun_tpu_torch import cli
    from shotgun_tpu_torch.io.packing import GenomeArrays
    from shotgun_tpu_torch.reference import KmerReference

    inp = _inputs(tiny_root, "tiny.deep", 5, tmp_path)
    ref = KmerReference.from_device_build(
        GenomeArrays(inp.descriptions, inp.codes, inp.offsets), inp.k, CPU)
    got = cli.create_alignment_from_reference(ref, inp.paths[0], CPU, 1, 1, None, None,
                                              None).get_summary()
    index = reference.build_index(torch.from_numpy(inp.codes), inp.offsets, inp.k)
    want = reference.summarize(index, inp.samples[0].codes, inp.samples[0].qual, inp.k,
                               reference.Gates(), inp.descriptions, CPU)
    assert got == want and list(got["Summary"]) == list(want["Summary"])


def test_check_counts_every_answer(tiny_root, tmp_path):
    from shotbench.harness import Request

    inp = _inputs(tiny_root, "tiny.shallow", 3, tmp_path)
    want = reference.summary_text(reference.summarize(
        reference.build_index(torch.from_numpy(inp.codes), inp.offsets, inp.k),
        inp.samples[1].codes, inp.samples[1].qual, inp.k, inp.gates,
        inp.descriptions, CPU))
    bad = json.loads(want)
    bad["Statistics"]["unmapped_reads"] += 2
    reqs = [Request(1, 1, 1, text=want), Request(1, 1, 1, text=json.dumps(bad, indent=4)),
            Request(1, 1, 1)]
    out = check(inp, reqs)
    assert out == {"failed_requests": 1, "mismatched_summaries": 1, "max_count_gap": 2,
                   "order_differs": 0}


@pytest.mark.parametrize("cell", ["tiny.deep", "tiny.shallow", "tiny.oneshot"])
@pytest.mark.parametrize("trace", [0, 1])
def test_run_on_cpu_is_correct(tiny_root, cell, trace):
    res = run_cell(tiny_root, cell, 2**31 + 7, 0.3, bool(trace), CPU, 0.0)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    if trace:
        assert "breakdown" in res and res["device"]["window_s"] > 0


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is for a machine without one")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "shotbench", "run.py"), "--workload",
         "strain.shallow", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA card" in proc.stderr
