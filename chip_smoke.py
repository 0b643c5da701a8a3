#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (shotgun_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each:
  1. device: the card's name and its power limit (nvidia-smi);
  2. build: the CUDA kernels from shotgun_tpu_torch/ops/kernels/csrc with
     nvcc, timed;
  3. database build on the device against the host build, both timed, on
     the phase-5 genomes (32 Mbp) and the phase-6 strain panel: equal
     distinct keys, genome counts and set membership per key; then the
     device assembly of the 32 Mbp 16-slot hash table, timed;
  4. kernels against their plain PyTorch versions on the card, at the main
     path's shapes (B = 32768 reads, row stride 160, k = 31, the
     device-assembled 16-slot table of phase 3 with a stash of planted
     entries; and H1 on the packed 32 Mbp genome as one row, as the device
     build runs it): exact equality, and the time of each beside its plain
     version;
  5. the main path: `-t dumpalign -g -k 31 --reads` through the port's CLI,
     in process, on 32 random 1 Mbp genomes (about 32M distinct 31-mers:
     the database builds on the device, and the auto probe picks the
     16-slot hash table, ~2.1 GB on the card, assembled there) and 524,288
     error-free 150 bp reads sampled from them; the route (stage
     db_build_device) and the summary are held against the known truth,
     and every kernel must have launched.  The genomes share no k-mer and
     the reads have no errors, so every read maps uniquely: a best case
     for speed, not a realistic panel;
  6. the strain panel: 32 genomes, 4 copies of each of 8 random 200 kbp
     ancestors with 1% substitutions (6.4 Mbp, about 3M distinct 31-mers,
     so the auto probe picks the sort join), and 524,288 150 bp reads with
     0.5% substitutions, through the CLI four times -- the device build
     (auto), the host build (SHOTGUN_TPU_DEVICE_BUILD=0), the host build
     with the 4-slot hash table (SHOTGUN_TPU_PROBE=hash), and the host
     build with the host-built 16-slot table (SHOTGUN_TPU_PROBE=hash16,
     the route of a .kdb or a -g input past the device build's window
     above the auto crossover): the four summaries must be byte-equal;
     each run's aligned reads/s is printed;
  7. the 13 dumpalign golden cases of tests/golden through the CLI on the
     card, byte for byte, on the auto route, on the sort join, on the
     4-slot hash table and with the device build forced.

Then one JSON line of per-kernel results and, last, the device line.  Any
failure raises and exits non-zero; so does a machine without CUDA, and a
directory that holds this script without the package.  Nothing here
imports the JAX package: data, reference and profiler come through
shotgun_tpu_torch.

Kernel H1 (encode_window) replaces two TPU kernels, the rolling encode and
the quality sums, in one launch; its entry gives the time of each mode,
and its launch count is that of every H1 launch on the main path (the
device build's window encode and the batches, with the MKQ gate, so keys
and sums together).  Each kernel's launches on every path (the main path
and the four strain-panel routes, each counted from 0) are listed too.
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
#: the strain panel: N_GENOMES = STRAINS ancestors x 4 mutated copies
STRAINS = 8
STRAIN_LEN = 200_000
MUTATION_RATE = 0.01
ERROR_RATE = 0.005
#: golden routes: (name, environment)
GOLDEN_ROUTES = [("auto", {}), ("sort", {"SHOTGUN_TPU_PROBE": "sort"}),
                 ("hash", {"SHOTGUN_TPU_PROBE": "hash"}),
                 ("device build", {"SHOTGUN_TPU_DEVICE_BUILD_MIN": "0"})]
ROUTE_ENV = ("SHOTGUN_TPU_PROBE", "SHOTGUN_TPU_DEVICE_BUILD",
             "SHOTGUN_TPU_DEVICE_BUILD_MIN", "SHOTGUN_TPU_DEVICE_BUILD_MAX")
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


def phase_kernels(tab, codes: np.ndarray, genomes, rng, device) -> list:
    """Phase 4: each kernel against its plain version at main-path shapes."""
    import torch

    from shotgun_tpu_torch.index.device_build import _host_prep
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
    # the device build's shape: the packed genome as one row
    row_d = torch.from_numpy(_host_prep(genomes)[0]).to(device)[None]
    row_keys, _ = encode_window(row_d, K)
    row_keys_p, _ = encode_window_plain(row_d, K)
    torch.cuda.synchronize()
    err_enc = max_abs_err([keys, row_keys], [keys_p, row_keys_p])
    err_qual = max_abs_err(kq, kq_p)
    del row_keys, row_keys_p

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
        ("genome row keys", lambda: encode_window(row_d, K),
         lambda: encode_window_plain(row_d, K)),
        ("probe", lambda: hash_probe(tab.table, stash, keys),
         lambda: hash_probe_plain(tab.table, stash, keys)),
    )}
    results = [
        {"name": "encode_window", "route": "cuda",
         "source": f"{CSRC}/encode_window.cu", "replaces": f"{PALLAS}:74",
         "also_replaces": f"{PALLAS}:107", "max_abs_err": max(err_enc, err_qual),
         "ms": times["keys+qual"][0], "plain_ms": times["keys+qual"][1],
         "ms_keys_only": times["keys"][0],
         "plain_ms_keys_only": times["keys"][1],
         "ms_genome_row": times["genome row keys"][0],
         "plain_ms_genome_row": times["genome row keys"][1]},
        {"name": "hash_probe", "route": "cuda",
         "source": f"{CSRC}/hash_probe.cu", "replaces": f"{PALLAS}:162",
         "max_abs_err": err_probe, "ms": times["probe"][0],
         "plain_ms": times["probe"][1]},
    ]
    say("phase 4 kernels == plain (integer outputs, tolerance 0) at B=%d "
        "L=%d k=%d (device-assembled table %s, stash %d rows, %d stash hits) "
        "and on the genome as one row of %d bases: %s" % (
            b, LPAD, K, tuple(tab.table.shape), stash.shape[0], n_stash_hits,
            row_d.shape[1] * 4,
            ", ".join(f"{name} {ms:.4f} ms vs plain {plain:.4f} ms"
                      for name, (ms, plain) in times.items())))
    return results


def run_cli(argv, env=None) -> str:
    """The port's CLI in process, with the route variables set to ``env``
    for the call."""
    from shotgun_tpu_torch.cli import main as cli_main

    saved = {name: os.environ.pop(name, None) for name in ROUTE_ENV}
    os.environ.update(env or {})
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli_main(argv)
    finally:
        for name, value in saved.items():
            os.environ.pop(name, None)
            if value is not None:
                os.environ[name] = value
    return buf.getvalue()


def counted_run(argv, env=None):
    """One profiled CLI run with every kernel's launch count set to 0 just
    before it: (stdout, {stage: seconds}, {kernel: launches}, wall s, peak
    device bytes)."""
    import torch

    from shotgun_tpu_torch.ops.encode import encode_window
    from shotgun_tpu_torch.ops.probe import hash_probe
    from shotgun_tpu_torch.utils.profiling import PROFILER

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PROFILER.stats.clear()
    PROFILER.enable()
    encode_window.launches = 0
    hash_probe.launches = 0
    t0 = time.perf_counter()
    out = run_cli(argv + ["--profile"], env)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"encode_window": encode_window.launches,
                "hash_probe": hash_probe.launches}
    PROFILER.enabled = False
    stages = {name: st.seconds for name, st in PROFILER.stats.items()}
    if "stream_align" not in stages or "align" in stages:
        raise AssertionError(f"the stream route did not run: {stages}")
    return out, stages, launches, wall, torch.cuda.max_memory_allocated()


def check_build(dev: dict, host, what: str) -> None:
    """The device build equals the host index: distinct keys, genome
    counts, and each key's set membership."""
    keys = dev["keys"].cpu().numpy()
    want = (host.kmer_hi.astype(np.int64) << 32) | host.kmer_lo.astype(np.int64)
    if not np.array_equal(keys, want):
        raise AssertionError(f"{what}: device-built keys != host keys")
    if not np.array_equal(dev["gc"].cpu().numpy(), host.genome_counts()):
        raise AssertionError(f"{what}: device genome counts != host")
    width = max(dev["set_masks"].shape[1], host.set_masks.shape[1])

    def rows(masks, sid):
        out = np.zeros((masks.shape[0], width), dtype=np.uint8)
        out[:, : masks.shape[1]] = masks
        return out[sid]

    if not np.array_equal(rows(dev["set_masks"], dev["sid"].cpu().numpy()),
                          rows(host.set_masks, host.set_id)):
        raise AssertionError(f"{what}: device set membership != host")


def phase_db_build(panels, device):
    """Phase 3: the device build against the host build on each panel,
    both timed, then the 16-slot table of the first panel assembled on
    the device; returns that table."""
    import torch

    from shotgun_tpu_torch.index.device_build import device_build_tables, device_hash_table
    from shotgun_tpu_torch.ops.probe import HashTableDev
    from shotgun_tpu_torch.reference import KmerReference

    parts, table = [], None
    for what, genomes in panels:
        t0 = time.perf_counter()
        host = KmerReference(K, genomes).index
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built = device_build_tables(genomes, K, device)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        if built is None:
            raise AssertionError(f"{what}: the device build refused the panel")
        check_build(built, host, what)
        part = (f"{what} ({genomes.codes.size} bp, {host.num_kmers} distinct "
                f"k-mers, {built['num_sets'] - genomes.num_records} multi sets): "
                f"device {dev_s:.3f} s (host packing {built['prep_s']:.3f} s) "
                f"vs host {host_s:.3f} s")
        if table is None:
            t0 = time.perf_counter()
            ht = device_hash_table(built)
            torch.cuda.synchronize()
            if ht is None:
                raise AssertionError(f"{what}: the 16-slot table was not assembled")
            table = HashTableDev(*ht)
            part += (f", 16-slot table {tuple(ht[0].shape)} assembled on the "
                     f"device {time.perf_counter() - t0:.3f} s")
        parts.append(part)
        del host, built
    say("phase 3 db build device == host (keys, genome counts, membership): "
        + "; ".join(parts))
    return table


def phase_main_path(fa: str, fq: str, gi: np.ndarray) -> dict:
    """Phase 5: dumpalign through the CLI, held against the known truth;
    returns each kernel's launch count in that run."""
    from shotgun_tpu_torch.io import native_available

    if not native_available():
        raise AssertionError("the native FASTQ library did not build")
    out, stages, launches, wall, peak = counted_run(
        ["-t", "dumpalign", "-g", fa, "-k", str(K), "--reads", fq,
         "--min-kmer-quality", str(MKQ)])
    if "db_build_device" not in stages or "db_build" in stages:
        raise AssertionError(f"the database was not built on the device: {stages}")
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
    say("phase 5 main path: %d reads, %d genomes x %d bp, k=%d, device build + "
        "hash16: wall %.3f s (fasta %.3f s, db build on the device %.3f s, "
        "hash table assembly %.3f s, stream align %.3f s), %.0f reads/s "
        "aligned, %.0f reads/s wall, peak device memory %d B, launches %s; "
        "summary == truth" % (
            n, N_GENOMES, GENOME_LEN, K, wall, stages.get("fasta_parse", 0.0),
            stages["db_build_device"], stages.get("table_build", 0.0),
            align_s, n / align_s, n / wall, peak, launches))
    return launches


def phase_strains(fa: str, fq: str) -> dict:
    """Phase 6: the strain panel through the CLI on four routes, byte-equal;
    returns each route's kernel launches."""
    routes = [("device build + sort", {}, "db_build_device", False),
              ("host build + sort", {"SHOTGUN_TPU_DEVICE_BUILD": "0"}, "db_build", False),
              ("host build + hash", {"SHOTGUN_TPU_PROBE": "hash"}, "db_build", True),
              ("host build + hash16", {"SHOTGUN_TPU_PROBE": "hash16"}, "db_build", True)]
    argv = ["-t", "dumpalign", "-g", fa, "-k", str(K), "--reads", fq]
    outs, parts, by_route = [], [], {}
    for name, env, build_stage, hashed in routes:
        out, stages, launches, wall, peak = counted_run(argv, env)
        if build_stage not in stages or (build_stage == "db_build"
                                         and "db_build_device" in stages):
            raise AssertionError(f"strains, {name}: stages {stages}")
        # the sort join launches no H2; every route encodes with H1
        if launches["encode_window"] <= 0 or (launches["hash_probe"] > 0) != hashed:
            raise AssertionError(f"strains, {name}: launches {launches}")
        outs.append(out)
        by_route[f"strains: {name}"] = launches
        align_s = stages["stream_align"]
        parts.append("%s: db build %.3f s, table %.3f s, stream align %.3f s = "
                     "%.0f reads/s aligned, wall %.3f s, peak %d B, launches %s" % (
                         name, stages[build_stage], stages.get("table_build", 0.0),
                         align_s, N_READS / align_s, wall, peak, launches))
    if outs[1:] != outs[:-1]:
        raise AssertionError("strain panel: the routes' summaries differ")
    stats = json.loads(outs[0])["Statistics"]
    if (sum(stats.values()) != N_READS or not stats["ambiguous_mapped_reads"]
            or not stats["unique_mapped_reads"]):
        raise AssertionError(f"strain panel: implausible statistics {stats}")
    say("phase 6 strain panel (%d genomes = %d ancestors x %d copies of %d bp at "
        "%.1f%% mutation, %d reads at %.1f%% errors): summaries byte-equal on "
        "%d routes, %s; %s" % (N_GENOMES, STRAINS, N_GENOMES // STRAINS, STRAIN_LEN,
                               100 * MUTATION_RATE, N_READS, 100 * ERROR_RATE,
                               len(routes), stats, "; ".join(parts)))
    return by_route


def phase_goldens() -> None:
    """Phase 7: the dumpalign golden cases on the card, byte for byte, on
    every route."""
    with open(os.path.join(GOLDEN, "manifest.json")) as fh:
        manifest = json.load(fh)
    data = os.path.join(GOLDEN, "data") + "/"
    for route, env in GOLDEN_ROUTES:
        for case in GOLDEN_CASES:
            argv = [a.replace("data/", data) for a in manifest[case]["args"]]
            out = run_cli(argv + ["--batch-size", "16"], env)
            with open(os.path.join(GOLDEN, f"{case}.out")) as fh:
                if out != fh.read():
                    raise AssertionError(f"golden {case} ({route}): output differs")
    say(f"phase 7 goldens: {len(GOLDEN_CASES)} dumpalign cases byte-equal on "
        f"the card on each route: {', '.join(r for r, _ in GOLDEN_ROUTES)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from shotgun_tpu_torch.ops.kernels.build import build, load_library
    from shotgun_tpu_torch.utils.synth import (
        make_genomes,
        sample_reads,
        synth_genomes,
        write_workload,
    )

    os.environ["SHOTGUN_TPU_TORCH_DEVICE"] = "cuda"
    for name in ROUTE_ENV:
        os.environ.pop(name, None)
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

    # data for phases 3 to 6
    rng = np.random.default_rng(args.seed)
    genomes = synth_genomes(rng, N_GENOMES, GENOME_LEN)
    work = sample_reads(rng, genomes, N_READS, READ_LEN)
    strains = make_genomes(rng, N_GENOMES, STRAIN_LEN, STRAINS, MUTATION_RATE)
    strain_work = sample_reads(rng, strains, N_READS, READ_LEN, ERROR_RATE)

    # 3. database build, device against host; 4. kernels against plain
    tab = phase_db_build([("32 Mbp main-path genomes", genomes),
                          ("strain panel", strains)], device)
    kernels = phase_kernels(tab, work.codes[:BATCH], genomes, rng, device)
    del tab
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # 5. main path
        fa = os.path.join(tmp, "genomes.fa")
        fq = os.path.join(tmp, "reads.fq")
        write_workload(work, fa, fq)
        gi = work.genome_of
        del genomes, work
        launches = phase_main_path(fa, fq, gi)
        torch.cuda.empty_cache()

        # 6. strain panel on four routes
        write_workload(strain_work, fa, fq)
        del strains, strain_work
        by_path = {"main path": launches, **phase_strains(fa, fq)}
    torch.cuda.empty_cache()

    # 7. goldens on the card, every route
    phase_goldens()

    for kr in kernels:
        kr["launches"] = launches[kr["name"]]
        kr["launches_by_path"] = {p: n[kr["name"]] for p, n in by_path.items()}
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
