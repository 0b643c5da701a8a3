"""The port's workload generator (shotgun_tpu_torch.utils.synth), its
reference built straight from genome arrays, and the profiling tools
(shotgun_tpu_torch.tools.profile_align, .bench_sortjoin, .bench_probe)
on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from shotgun_tpu.aligner import PseudoAlignment as JaxPseudoAlignment
from shotgun_tpu.index.build import build_index
from shotgun_tpu.io.data_file import open_fastq_stream
from shotgun_tpu.reference import KmerReference as JaxKmerReference
from shotgun_tpu_torch.aligner import PseudoAlignment
from shotgun_tpu_torch.io import data_file as tdf
from shotgun_tpu_torch.io import native_available
from shotgun_tpu_torch.reference import KmerReference
from shotgun_tpu_torch.ops.encode import mix32_np
from shotgun_tpu_torch.ops.probe import hash_probe_plain
from shotgun_tpu_torch.ops.probe_sort2 import probe_dedupe_sorted
from shotgun_tpu_torch.tools import bench_probe, bench_sortjoin, profile_align
from shotgun_tpu_torch.utils import synth

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _kmers(codes, k):
    return {codes[i: i + k].tobytes() for i in range(codes.size - k + 1)}


def test_make_genomes_strains_share_kmers_and_every_mutation_changes_a_base():
    rng = np.random.default_rng(0)
    g = synth.make_genomes(rng, 4, 3000, strains=2, mutation_rate=0.01)
    assert g.num_records == 4 and g.codes.size == 12000
    a, b, c = (g.record_codes(i) for i in (0, 2, 1))
    # 0 and 2 copy one ancestor: each differs from it at ~1% of bases,
    # so from each other at ~2%; 0 and 1 come from different ancestors
    assert 0.005 < np.mean(a != b) < 0.04
    assert np.mean(a != c) > 0.6
    shared = _kmers(a, 21) & _kmers(b, 21)
    assert len(shared) > 1000 and not _kmers(a, 21) & _kmers(c, 21)
    assert g.codes.max() <= 3


def test_make_genomes_without_strains_is_the_shared_generator():
    want = synth.synth_genomes(np.random.default_rng(5), 3, 500)
    got = synth.make_genomes(np.random.default_rng(5), 3, 500)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.descriptions == want.descriptions


@pytest.mark.parametrize("error_rate", [0.0, 0.02])
def test_sample_reads_truth_and_errors(error_rate):
    rng = np.random.default_rng(1)
    g = synth.make_genomes(rng, 3, 2000)
    work = synth.sample_reads(rng, g, 400, 100, error_rate)
    assert work.codes.shape == (400, 100) and work.genome_of.shape == (400,)
    # each read is within error_rate of some window of its own genome
    diffs = []
    for read, gi in zip(work.codes[:50], work.genome_of[:50]):
        rec = g.record_codes(int(gi))
        win = np.lib.stride_tricks.sliding_window_view(rec, 100)
        diffs.append(int((win != read).sum(axis=1).min()))
    if error_rate == 0:
        assert max(diffs) == 0
    else:
        assert 0 < np.mean(diffs) < 10


def test_write_workload_round_trips_and_reference_from_arrays(tmp_path):
    rng = np.random.default_rng(2)
    g = synth.make_genomes(rng, 3, 1500, strains=1, mutation_rate=0.02)
    work = synth.sample_reads(rng, g, 200, 80, 0.01)
    fa, fq = str(tmp_path / "g.fa"), str(tmp_path / "r.fq")
    synth.write_workload(work, fa, fq)
    from_arrays = KmerReference(21, g, device=CPU).index
    from_fasta = KmerReference(21, tdf.FASTAFile(fa).container, device=CPU).index
    for name in ("kmer_words", "set_id", "set_masks", "post_offsets"):
        np.testing.assert_array_equal(getattr(from_arrays, name),
                                      getattr(from_fasta, name), err_msg=name)
    assert from_arrays.descriptions == from_fasta.descriptions
    stream = tdf.open_fastq_stream(fq, lazy=True)
    assert stream is not None and stream.max_len == 80


def test_strain_workload_with_errors_matches_jax(tmp_path):
    """The port's align_stream against the JAX package's on genomes that
    share most k-mers and reads with errors (ambiguous reads at scale)."""
    rng = np.random.default_rng(3)
    g = synth.make_genomes(rng, 6, 4000, strains=2, mutation_rate=0.01)
    work = synth.sample_reads(rng, g, 600, 150, 0.005)
    fa, fq = str(tmp_path / "g.fa"), str(tmp_path / "r.fq")
    synth.write_workload(work, fa, fq)
    index = build_index(g, 31)
    jpa = JaxPseudoAlignment(JaxKmerReference(31, _index=index))
    jpa.align_stream(open_fastq_stream(fq, lazy=True), 1, 1, batch_size=128)
    pa = PseudoAlignment(KmerReference(31, g, device=CPU), CPU)
    pa.align_stream(tdf.open_fastq_stream(fq, lazy=True), 1, 1, batch_size=128)
    assert pa.get_summary() == jpa.get_summary()
    stats = pa.get_summary()["Statistics"]
    assert stats["ambiguous_mapped_reads"] > 50 and stats["unique_mapped_reads"] > 50


def _x(cat, ts, dur, name="k"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}


@pytest.mark.parametrize("events, busy", [
    ([], 0.0),
    ([_x("kernel", 0, 10)], 10.0),
    # overlap and containment count once, gaps not at all
    ([_x("kernel", 0, 10), _x("gpu_memcpy", 5, 10), _x("kernel", 6, 2),
      _x("gpu_memset", 30, 5)], 20.0),
    # host ops, runtime calls and flow events are not device time
    ([_x("cpu_op", 0, 100), _x("cuda_runtime", 0, 50),
      {"ph": "f", "cat": "kernel", "ts": 0}, _x("kernel", 40, 4)], 4.0),
])
def test_device_busy_is_the_union_of_device_intervals(events, busy):
    assert profile_align.device_busy_us(events) == busy


def test_device_ms_by_name_sums_device_events_largest_first():
    ev = [_x("kernel", 0, 1000, "a"), _x("kernel", 5, 3000, "b"),
          _x("kernel", 9, 1000, "a"), _x("cpu_op", 0, 9000, "a")]
    assert list(profile_align.device_ms_by_name(ev).items()) == [("b", 3.0), ("a", 2.0)]


def test_profile_align_runs_on_cpu_and_reports_no_device_metric(capsys, monkeypatch):
    assert native_available()
    monkeypatch.delenv(profile_align.FILL_ENV, raising=False)
    res = profile_align.main([
        "--device", "cpu", "--genomes", "3", "--genome-len", "4000",
        "--reads", "500", "--batch", "256", "--repeats", "1", "--strains", "2",
        "--mutation-rate", "0.01", "--error-rate", "0.005", "--fill-threads", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(res))
    assert "device busy time and idle share: not measured" in "\n".join(out)
    assert not any(key.startswith("profiled_") for key in res)
    assert sum(res["statistics"].values()) == 500
    assert set(res["stream_reads_per_s"]) == {
        "B=256", "B=256 mkq=30", "B=64", "B=512", "B=256 threads=1"}
    assert os.environ.get(profile_align.FILL_ENV) is None


@pytest.mark.parametrize("probe", ["sort", "hash16"])
def test_profile_align_probe_and_device_build(probe, capsys, monkeypatch):
    """``--probe`` picks the table of every run and ``--device-build``
    builds the database on the device; the workload's statistics do not
    change with either, and the probe setting is restored afterwards."""
    monkeypatch.setenv("SHOTGUN_TPU_PROBE", "hash")
    argv = ["--device", "cpu", "--genomes", "3", "--genome-len", "4000",
            "--reads", "300", "--batch", "128", "--repeats", "1", "--strains", "2",
            "--mutation-rate", "0.01", "--error-rate", "0.005", "--probe", probe]
    host = profile_align.main(argv)
    dev = profile_align.main(argv + ["--device-build"])
    capsys.readouterr()
    assert host["probe_used"] == dev["probe_used"] == probe
    assert dev["workload"]["device_build"] and not host["workload"]["device_build"]
    assert host["statistics"] == dev["statistics"]
    assert host["distinct_kmers"] == dev["distinct_kmers"]
    assert os.environ["SHOTGUN_TPU_PROBE"] == "hash"


def test_bench_sortjoin_case_has_hits_repeats_and_gated_windows():
    tab, keys, ok = bench_sortjoin.make_case(np.random.default_rng(9), 3000, 32, CPU)
    assert keys.shape == (32, bench_sortjoin.WINDOWS)
    assert bool((tab.keys[1:] > tab.keys[:-1]).all()) and tab.keys.numel() == 3000
    hit, sid, gc, first = probe_dedupe_sorted(tab, keys, ok)
    assert 0.3 < hit.float().mean() < 0.7 and not ok.all()
    assert bool((first <= hit).all()) and int(hit.sum()) > int(first.sum())


def test_bench_sortjoin_runs_on_cpu_and_reports_no_device_metric(capsys):
    """Every variant agrees with the pipeline's join, and the times are
    labelled as the host's clock."""
    res = bench_sortjoin.main(["--device", "cpu", "--keys", "500", "20000",
                               "--batch", "48", "--iters", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(res))
    assert res["timer"] == "host clock, not a device metric"
    assert [r["keys"] for r in res["runs"]] == [500, 20000]
    for run in res["runs"]:
        assert run["cummax_equal"] and all(run["hash16_equal"].values())
        assert run["sorted_rows"] == run["keys"] + 48 * bench_sortjoin.WINDOWS
        assert set(run["ms"]) == {"join", "join_cummax", "sort_stable",
                                  "sort_unstable", "cummax", "cumsum",
                                  "scatter_restore", "hash16"}


def test_bench_probe_cases_are_the_two_hash_layouts():
    """bench_probe's shapes at a small size: the device-assembled 16-slot
    table and the host-built 4-slot one, one batch of window keys each,
    the stash planted to 64 rows, and the byte count of the bound."""
    rng = np.random.default_rng(11)
    cases = bench_probe.make_cases(rng, CPU, genomes=4, genome_len=20_000, strains=2,
                                   strain_len=5_000, batch=64)
    assert [c["name"] for c in cases] == ["16-slot", "4-slot"]
    for case, slots in zip(cases, (16, 4)):
        table, stash, keys = case["table"], case["stash"], case["keys"]
        assert table.shape[1:] == (slots, 4) and stash.shape == (64, 4)
        assert keys.shape == (64, bench_probe.LPAD - bench_probe.K + 1)
        k = keys.numpy().reshape(-1)
        lo, hi = (k & 0xFFFFFFFF).astype(np.uint32), (k >> 32).astype(np.uint32)
        buckets = np.unique(mix32_np(lo, hi) & np.uint32(table.shape[0] - 1)).size
        assert case["buckets"] == buckets
        assert case["bytes"] == k.size * 20 + buckets * slots * 16 + 64 * 16
        sid, gc, pos = hash_probe_plain(table, stash, keys)
        stash_hits = pos >= 0x7FFF0000
        assert 0.5 < float((sid >= 0).float().mean()) < 1
        assert bool(stash_hits.any()) and bool(((sid >= 0) & ~stash_hits).any())


def test_bench_probe_exits_1_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench_probe.main(["--iters", "1"])
    assert exc.value.code == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err


def test_kernel_build_compiles_every_source_at_once_then_links(tmp_path, monkeypatch):
    """``build`` starts one nvcc a source for sm_90a with the ptxas report,
    links the objects once into the library, keeps the report as its log,
    and reuses a library newer than every source; no nvcc runs here: the
    compiler is a stand-in that records its arguments."""
    from shotgun_tpu_torch.ops.kernels import build as kbuild

    seen = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            seen.append(cmd)
            out = cmd[cmd.index("-o") + 1]
            with open(out, "w") as fh:
                fh.write("x")

        def communicate(self):
            return "", "ptxas info"

    monkeypatch.setattr(kbuild, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kbuild.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(kbuild.subprocess, "run", FakeProc)
    res = kbuild.build(force=True, build_dir=str(tmp_path / "k"))
    compiles, link = seen[:-1], seen[-1]
    srcs = kbuild.sources()
    assert len(srcs) >= 3 and [cmd[-1] for cmd in compiles] == srcs
    for cmd in compiles:
        assert "-c" in cmd and "-v" in cmd and kbuild.ARCH_FLAGS[1] in cmd
    objs = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert "-shared" in link and link[-len(objs):] == objs
    assert res.path == str(tmp_path / "k" / kbuild.LIB_NAME) and os.path.exists(res.path)
    assert res.log == "ptxas info" * len(srcs)
    assert sorted(os.listdir(tmp_path / "k")) == [kbuild.LIB_NAME]  # objects removed
    again = kbuild.build(build_dir=str(tmp_path / "k"))
    assert len(seen) == len(srcs) + 1 and again == (res.path, 0.0, "")
