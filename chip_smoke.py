#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (shotgun_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each:
  1. device: the card's name and its power limit (nvidia-smi);
  2. build: the CUDA kernels from shotgun_tpu_torch/ops/kernels/csrc with
     nvcc, timed;
  3. kernels against their plain PyTorch versions on the card, at the main
     path's shapes (B = 32768 reads, row stride 160, k = 31, the phase-4
     16-slot table with a stash of planted entries): exact equality, and
     the time of each beside its plain version;
  4. the main path: `-t dumpalign -g -k 31 --reads` through the port's CLI,
     in process, on 32 random 1 Mbp genomes (about 32M distinct 31-mers,
     so the auto probe picks the 16-slot hash table, ~2.1 GB on the card)
     and 524,288 error-free 150 bp reads sampled from them; the summary is
     held against the known truth and every kernel must have launched.
     The genomes share no k-mer and the reads have no errors, so every
     read maps uniquely: a best case for speed, not a realistic panel;
  5. the 13 dumpalign golden cases of tests/golden through the CLI on the
     card, byte for byte.

Then one JSON line of per-kernel results and, last, the device line.  Any
failure raises and exits non-zero; so does a machine without CUDA, and a
directory that holds this script without the package.  Nothing here
imports the JAX package: data, reference and profiler come through
shotgun_tpu_torch.

Kernel H1 (encode_window) replaces two TPU kernels, the rolling encode and
the quality sums, in one launch; its entry gives the time of each mode,
and its launch count is that of every H1 launch on the main path, which
runs with the MKQ gate and so computes keys and sums together.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
GOLDEN_CASES = ["plain", "m2", "m0", "p0", "p5", "pneg", "mrq", "mkq",
                "mg0", "mg1", "mg2", "combo", "sim-align"]
K = 31
BATCH = 32768
LPAD = 160
N_GENOMES = 32
GENOME_LEN = 1_000_000
N_READS = 524_288
READ_LEN = 150
#: main-path MKQ gate: every window of the all-'I' reads passes it, so the
#: run exercises the quality-sum kernel without changing the truth
MKQ = 30
PALLAS = "shotgun_tpu/ops/pallas/kernels.py"
CSRC = "shotgun_tpu_torch/ops/kernels/csrc"


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(got, want) -> int:
    """Largest |got - want| over the tensors; raises unless they are equal
    in shape and dtype (every output here is an integer, compared exactly)."""
    import torch

    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"kernel gave {g.dtype} {tuple(g.shape)}, "
                                 f"plain {w.dtype} {tuple(w.shape)}")
        worst = max(worst, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max().item()) if g.numel() else 0)
    return worst


def plant_stash(real_stash: np.ndarray, hit_keys: np.ndarray,
                miss_keys: np.ndarray, rng) -> np.ndarray:
    """The real stash plus planted rows up to 64: keys the queries hit in
    the table (so stash and table matches merge by min/max/min), repeats
    of them with other values, keys of windows the table misses (so they
    resolve through the stash alone) and keys nothing hits."""
    room = 64 - real_stash.shape[0]
    q = room // 4
    hits = rng.choice(np.unique(hit_keys), size=q, replace=False)
    misses = rng.choice(np.unique(miss_keys), size=q, replace=False)
    planted = np.concatenate([hits, hits, misses,
                              rng.integers(0, 1 << 62, size=room - 3 * q)])
    rows = np.empty((planted.size, 4), dtype=np.uint32)
    rows[:, 0] = planted & 0xFFFFFFFF
    rows[:, 1] = planted >> 32
    rows[:, 2] = rng.integers(0, 1 << 20, size=planted.size)
    rows[:, 3] = rng.integers(1, 8, size=planted.size)
    return np.concatenate([real_stash, rows])


def phase_kernels(tab, codes: np.ndarray, rng, device) -> list:
    """Phase 3: each kernel against its plain version at main-path shapes."""
    import torch

    from shotgun_tpu_torch.ops.encode import (
        encode_window,
        encode_window_plain,
        pack_codes_2bit,
    )
    from shotgun_tpu_torch.ops.probe import hash_probe, hash_probe_plain

    b, length = codes.shape
    padded = np.zeros((b, LPAD), dtype=np.uint8)
    padded[:, :length] = codes
    qual = np.zeros((b, LPAD), dtype=np.uint8)
    qual[:, :length] = rng.integers(33, 127, size=(b, length), dtype=np.uint8)
    packed_d = torch.from_numpy(pack_codes_2bit(padded)).to(device)
    qual_d = torch.from_numpy(qual).to(device)

    keys, _ = encode_window(packed_d, K)
    keys_p, _ = encode_window_plain(packed_d, K)
    kq = encode_window(packed_d, K, qual_d)
    kq_p = encode_window_plain(packed_d, K, qual_d)
    torch.cuda.synchronize()
    err_enc = max_abs_err([keys], [keys_p])
    err_qual = max_abs_err(kq, kq_p)

    # windows past the read end reach into the zero padding: the table
    # misses them, so planting their keys gives stash-only hits
    keys_np = keys.cpu().numpy()
    stash_np = plant_stash(tab.stash.cpu().numpy().view(np.uint32),
                           keys_np[:, :length - K + 1],
                           keys_np[:, length - K + 1:], rng)
    stash = torch.from_numpy(stash_np.view(np.int32)).to(device)
    probe = hash_probe(tab.table, stash, keys)
    probe_p = hash_probe_plain(tab.table, stash, keys)
    torch.cuda.synchronize()
    err_probe = max_abs_err(probe, probe_p)
    n_stash_hits = int((probe[2] >= 0x7FFF0000).sum().item())
    if max(err_enc, err_qual, err_probe) != 0:
        raise AssertionError(f"kernel != plain: encode {err_enc}, "
                             f"encode+qual {err_qual}, probe {err_probe}")
    if n_stash_hits == 0:
        raise AssertionError("no window resolved through the planted stash")

    times = {name: (cuda_ms(fn, 50), cuda_ms(plain, 5)) for name, fn, plain in (
        ("keys", lambda: encode_window(packed_d, K),
         lambda: encode_window_plain(packed_d, K)),
        ("keys+qual", lambda: encode_window(packed_d, K, qual_d),
         lambda: encode_window_plain(packed_d, K, qual_d)),
        ("probe", lambda: hash_probe(tab.table, stash, keys),
         lambda: hash_probe_plain(tab.table, stash, keys)),
    )}
    results = [
        {"name": "encode_window", "route": "cuda",
         "source": f"{CSRC}/encode_window.cu", "replaces": f"{PALLAS}:74",
         "also_replaces": f"{PALLAS}:107", "max_abs_err": max(err_enc, err_qual),
         "ms": times["keys+qual"][0], "plain_ms": times["keys+qual"][1],
         "ms_keys_only": times["keys"][0],
         "plain_ms_keys_only": times["keys"][1]},
        {"name": "hash_probe", "route": "cuda",
         "source": f"{CSRC}/hash_probe.cu", "replaces": f"{PALLAS}:162",
         "max_abs_err": err_probe, "ms": times["probe"][0],
         "plain_ms": times["probe"][1]},
    ]
    say("phase 3 kernels == plain (integer outputs, tolerance 0) at B=%d "
        "L=%d k=%d (table %s, stash %d rows, %d stash hits): %s" % (
            b, LPAD, K, tuple(tab.table.shape), stash.shape[0], n_stash_hits,
            ", ".join(f"{name} {ms:.4f} ms vs plain {plain:.4f} ms"
                      for name, (ms, plain) in times.items())))
    return results


def run_cli(argv) -> str:
    from shotgun_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    return buf.getvalue()


def phase_main_path(fa: str, fq: str, gi: np.ndarray) -> dict:
    """Phase 4: dumpalign through the CLI, held against the known truth;
    returns each kernel's launch count in that run."""
    import torch

    from shotgun_tpu_torch.io import native_available
    from shotgun_tpu_torch.ops.encode import encode_window
    from shotgun_tpu_torch.ops.probe import hash_probe
    from shotgun_tpu_torch.utils.profiling import PROFILER

    if not native_available():
        raise AssertionError("the native FASTQ library did not build")
    encode_window.launches = 0
    hash_probe.launches = 0
    torch.cuda.reset_peak_memory_stats()
    PROFILER.stats.clear()
    PROFILER.enable()
    t0 = time.perf_counter()
    out = run_cli(["-t", "dumpalign", "-g", fa, "-k", str(K), "--reads", fq,
                   "--min-kmer-quality", str(MKQ), "--profile"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"encode_window": encode_window.launches,
                "hash_probe": hash_probe.launches}
    PROFILER.enabled = False
    peak = torch.cuda.max_memory_allocated()

    stages = {name: st.seconds for name, st in PROFILER.stats.items()}
    if "stream_align" not in stages or "align" in stages:
        raise AssertionError(f"the stream route did not run: {stages}")
    summary = json.loads(out)
    stats = summary["Statistics"]
    n = int(gi.size)
    want_stats = {"unique_mapped_reads": n, "ambiguous_mapped_reads": 0,
                  "unmapped_reads": 0, "filtered_quality_kmers": 0}
    if stats != want_stats:
        raise AssertionError(f"Statistics {stats} != {want_stats}")
    counts = np.bincount(gi, minlength=N_GENOMES)
    first = np.unique(gi, return_index=True)[1]
    order = [f"genome_{g}" for g in np.unique(gi)[np.argsort(first)]]
    if list(summary["Summary"]) != order:
        raise AssertionError("Summary order != first appearance among reads")
    for g in range(N_GENOMES):
        got = summary["Summary"].get(f"genome_{g}")
        if got != {"unique_reads": int(counts[g]), "ambiguous_reads": 0}:
            raise AssertionError(f"genome_{g}: {got}, want {counts[g]} unique")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the main path: {launches}")
    align_s = stages["stream_align"]
    say("phase 4 main path: %d reads, %d genomes x %d bp, k=%d, hash16: wall "
        "%.3f s (fasta %.3f s, db build %.3f s, table build + upload %.3f s, "
        "stream align %.3f s), %.0f reads/s aligned, %.0f reads/s wall, "
        "peak device memory %d B, launches %s; summary == truth" % (
            n, N_GENOMES, GENOME_LEN, K, wall, stages.get("fasta_parse", 0.0),
            stages.get("db_build", 0.0), stages.get("table_build", 0.0),
            align_s, n / align_s, n / wall, peak, launches))
    return launches


def phase_goldens() -> None:
    """Phase 5: the dumpalign golden cases on the card, byte for byte."""
    with open(os.path.join(GOLDEN, "manifest.json")) as fh:
        manifest = json.load(fh)
    data = os.path.join(GOLDEN, "data") + "/"
    for case in GOLDEN_CASES:
        argv = [a.replace("data/", data) for a in manifest[case]["args"]]
        out = run_cli(argv + ["--batch-size", "16"])
        with open(os.path.join(GOLDEN, f"{case}.out")) as fh:
            if out != fh.read():
                raise AssertionError(f"golden {case}: output differs")
    say(f"phase 5 goldens: {len(GOLDEN_CASES)} dumpalign cases byte-equal on the card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from shotgun_tpu_torch.ops.kernels.build import build, load_library
    from shotgun_tpu_torch.reference import KmerReference
    from shotgun_tpu_torch.utils.synth import sample_reads, synth_genomes, write_workload

    os.environ["SHOTGUN_TPU_TORCH_DEVICE"] = "cuda"
    os.environ.pop("SHOTGUN_TPU_PROBE", None)
    device = torch.device("cuda", 0)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    say(f"phase 1 device: {name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    say(smi)

    # 2. build
    built = build(force=True)
    load_library()
    say(f"phase 2 build: nvcc sm_90a, {len(built.log.splitlines())} ptxas "
        f"lines, {built.seconds:.3f} s")
    print(built.log, file=sys.stderr, flush=True)

    # data for phases 3 and 4
    rng = np.random.default_rng(args.seed)
    genomes = synth_genomes(rng, N_GENOMES, GENOME_LEN)
    work = sample_reads(rng, genomes, N_READS, READ_LEN)
    ref = KmerReference(K, genomes)
    tab = ref.device_probe_tables(device)
    if ref.probe_method() != "hash16":
        raise AssertionError(f"auto probe picked {ref.probe_method()}, not hash16")

    # 3. kernels against plain
    kernels = phase_kernels(tab, work.codes[:BATCH], rng, device)
    del ref, tab
    torch.cuda.empty_cache()

    # 4. main path
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "genomes.fa")
        fq = os.path.join(tmp, "reads.fq")
        write_workload(work, fa, fq)
        gi = work.genome_of
        del genomes, work
        launches = phase_main_path(fa, fq, gi)
    torch.cuda.empty_cache()

    # 5. goldens on the card
    phase_goldens()

    for kr in kernels:
        kr["launches"] = launches[kr["name"]]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
