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
     4-slot hash table and with the device build forced; on each route
     also the 3 dumpref cases and the corpus through reference -> align ->
     dumpalign -a, which must print the plain case;
  8. the rest of the CLI at size, in the directory of phases 5 and 6:
     a. the strain panel: -t reference (host build, .kdb saved);
        dumpref -r of that file and dumpref -g, each to a file, equal
        SHA-256; -t align of phase 6's reads on the auto route (sort), the
        4-slot and the 16-slot hash tables, and with -g and -r given (-r
        wins, as in the JAX CLI): the four .aln files byte-equal, H1
        launched on every route and H2 on the hash routes only; dumpalign
        -a of the sort .aln equal to dumpalign -r --reads; each align's
        reads/s beside the dumpalign stream's, and the bytes of mapping
        lists fetched per batch;
     b. the 32 Mbp main-path workload: -t reference, then -t align (auto:
        the host-built 16-slot table, so H2 runs), then the .aln loaded
        back and its read store held against the truth read by read (ids
        in input order, every read unique, every list its genome); the
        stages, the .kdb/.aln sizes with their write and load seconds, the
        align reads/s and the peak device memory;
     c. EXTSIM at G = 512 (64 ancestors x 8 copies of 20 kbp at 1%
        mutation): the overlap matrix on the card equal to the JAX
        package's host product, both timed, and dumpref --filter-similar
        on the panel through the CLI, which must drop genomes.

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
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
GOLDEN_CASES = ["plain", "m2", "m0", "p0", "p5", "pneg", "mrq", "mkq",
                "mg0", "mg1", "mg2", "combo", "sim-align"]
DUMPREF_CASES = ["dumpref", "dumpref-sim75", "dumpref-sim0"]
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
#: the EXTSIM panel of phase 8c: EXT_ANCESTORS x 8 copies of EXT_LEN bases
EXT_GENOMES = 512
EXT_ANCESTORS = 64
EXT_LEN = 20_000
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


def run_cli(argv, env=None, out_path=None) -> str:
    """The port's CLI in process, with the route variables set to ``env``
    for the call; stdout goes to ``out_path`` when given (and "" is
    returned)."""
    from shotgun_tpu_torch.cli import main as cli_main

    saved = {name: os.environ.pop(name, None) for name in ROUTE_ENV}
    os.environ.update(env or {})
    buf = io.StringIO()
    try:
        with contextlib.ExitStack() as stack:
            if out_path is not None:
                buf = stack.enter_context(open(out_path, "w"))
            stack.enter_context(contextlib.redirect_stdout(buf))
            cli_main(argv)
    finally:
        for name, value in saved.items():
            os.environ.pop(name, None)
            if value is not None:
                os.environ[name] = value
    return "" if out_path is not None else buf.getvalue()


def counted_run(argv, env=None, out_path=None, stream=True):
    """One profiled CLI run with every kernel's launch count set to 0 just
    before it: (stdout, {stage: seconds}, {kernel: launches}, wall s, peak
    device bytes).  ``stream``: the run aligns reads, and must take the
    stream route."""
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
    out = run_cli(argv + ["--profile"], env, out_path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"encode_window": encode_window.launches,
                "hash_probe": hash_probe.launches}
    PROFILER.enabled = False
    stages = {name: st.seconds for name, st in PROFILER.stats.items()}
    if stream and ("stream_align" not in stages or "align" in stages):
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


def golden(case: str) -> str:
    with open(os.path.join(GOLDEN, f"{case}.out")) as fh:
        return fh.read()


def phase_goldens(tmp: str) -> None:
    """Phase 7: the dumpalign and dumpref golden cases on the card, byte
    for byte, and the corpus through reference -> align -> dumpalign -a,
    on every route."""
    with open(os.path.join(GOLDEN, "manifest.json")) as fh:
        manifest = json.load(fh)
    data = os.path.join(GOLDEN, "data") + "/"
    kdb, aln = os.path.join(tmp, "corpus.kdb"), os.path.join(tmp, "corpus.aln")
    for route, env in GOLDEN_ROUTES:
        for case in GOLDEN_CASES + DUMPREF_CASES:
            argv = [a.replace("data/", data) for a in manifest[case]["args"]]
            if run_cli(argv + ["--batch-size", "16"] * (case in GOLDEN_CASES),
                       env) != golden(case):
                raise AssertionError(f"golden {case} ({route}): output differs")
        run_cli(["-t", "reference", "-g", data + "corpus.fa", "-k", "11",
                 "-r", kdb], env)
        run_cli(["-t", "align", "-r", kdb, "--reads", data + "corpus.fq",
                 "-a", aln, "--batch-size", "16"], env)
        if run_cli(["-t", "dumpalign", "-a", aln], env) != golden("plain"):
            raise AssertionError(f"reference -> align -> dumpalign -a ({route}): "
                                 "output differs from the plain case")
    say(f"phase 7 goldens: {len(GOLDEN_CASES)} dumpalign and {len(DUMPREF_CASES)} "
        "dumpref cases byte-equal on the card, and reference -> align -> "
        "dumpalign -a equal to the plain case, on each route: "
        f"{', '.join(r for r, _ in GOLDEN_ROUTES)}")


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def fetched_bytes_per_batch(aln, n_reads: int, batch: int) -> float:
    """Bytes of the read store copied to the host per batch: a mapping-type
    byte and a 4-byte list length per read, 8 bytes per list entry."""
    n_batches = -(-n_reads // batch)
    entries = sum(int(x.size) for x in aln._list_flat)
    return (5 * n_reads + 8 * entries) / n_batches


def phase_strain_files(tmp: str, fa: str, fq: str) -> dict:
    """Phase 8a: reference, dumpref, align and dumpalign -a on the strain
    panel; returns each align route's kernel launches."""
    from shotgun_tpu_torch.aligner import PseudoAlignment

    kdb = os.path.join(tmp, "s.kdb")
    _, st, _, wall, _ = counted_run(
        ["-t", "reference", "-g", fa, "-k", str(K), "-r", kdb], stream=False)
    parts = ["reference: wall %.3f s (db build %.3f s, .kdb write %.3f s), "
             ".kdb %d B" % (wall, st["db_build"], st["kdb_save"],
                            os.path.getsize(kdb))]
    dumps = []
    for name, argv in (("dumpref -r", ["-r", kdb]),
                       ("dumpref -g", ["-g", fa, "-k", str(K)])):
        path = os.path.join(tmp, f"s_dumpref_{len(dumps)}.json")
        _, st, _, wall, _ = counted_run(["-t", "dumpref"] + argv, out_path=path,
                                        stream=False)
        size = os.path.getsize(path)
        dumps.append(sha256(path))
        parts.append("%s: %d B in %.3f s (%.1f MB/s written), wall %.3f s" % (
            name, size, st["dumpref"], size / st["dumpref"] / 1e6, wall))
        os.remove(path)
    if dumps[0] != dumps[1]:
        raise AssertionError("strain panel: dumpref -r and dumpref -g differ")

    routes = [("sort", {}, ["-r", kdb], False),
              ("hash", {"SHOTGUN_TPU_PROBE": "hash"}, ["-r", kdb], True),
              ("hash16", {"SHOTGUN_TPU_PROBE": "hash16"}, ["-r", kdb], True),
              ("-g and -r", {}, ["-g", fa, "-k", str(K), "-r", kdb], False)]
    by_route, digests = {}, []
    for name, env, src, hashed in routes:
        aln = os.path.join(tmp, f"s_{len(digests)}.aln")
        _, st, launches, wall, peak = counted_run(
            ["-t", "align"] + src + ["--reads", fq, "-a", aln], env)
        if launches["encode_window"] <= 0 or (launches["hash_probe"] > 0) != hashed:
            raise AssertionError(f"strains align, {name}: launches {launches}")
        digests.append(sha256(aln))
        by_route[f"strains align: {name}"] = launches
        parts.append("align %s: stream %.3f s = %.0f reads/s aligned (of it the "
                     "read store's host work %.3f s), table %.3f s, .aln write "
                     "%.3f s, wall %.3f s, peak %d B, launches %s" % (
                         name, st["stream_align"], N_READS / st["stream_align"],
                         st["read_store"], st.get("table_build", 0.0),
                         st["aln_save"], wall, peak, launches))
    if len(set(digests)) != 1:
        raise AssertionError("strain panel: the .aln files of the routes differ")
    aln = os.path.join(tmp, "s_0.aln")
    parts.append(".aln %d B, %.0f B of mapping lists fetched per batch of %d" % (
        os.path.getsize(aln),
        fetched_bytes_per_batch(PseudoAlignment.load(aln), N_READS, BATCH), BATCH))
    direct, st, _, _, _ = counted_run(["-t", "dumpalign", "-r", kdb, "--reads", fq])
    parts.append("dumpalign -r --reads (the same panel and table): stream %.3f s "
                 "= %.0f reads/s aligned" % (st["stream_align"],
                                              N_READS / st["stream_align"]))
    if run_cli(["-t", "dumpalign", "-a", aln]) != direct:
        raise AssertionError("strain panel: dumpalign -a != dumpalign -r --reads")
    for i in range(len(routes)):
        os.remove(os.path.join(tmp, f"s_{i}.aln"))
    os.remove(kdb)
    say("phase 8a strain panel, the rest of the CLI: dumpref -r == dumpref -g "
        "(SHA-256), the .aln of %d align routes byte-equal, dumpalign -a == "
        "dumpalign -r --reads; %s" % (len(routes), "; ".join(parts)))
    return by_route


def phase_main_files(tmp: str, fa: str, fq: str, gi: np.ndarray) -> dict:
    """Phase 8b: the 32 Mbp workload through reference and align, the
    read store loaded back and held against the truth; returns the align
    run's kernel launches."""
    from shotgun_tpu_torch.aligner import PseudoAlignment

    say("phase 8b: %d B free in %s before the 32 Mbp .kdb and .aln" % (
        shutil.disk_usage(tmp).free, tmp))
    kdb, aln = os.path.join(tmp, "m.kdb"), os.path.join(tmp, "m.aln")
    _, ref_st, _, ref_wall, _ = counted_run(
        ["-t", "reference", "-g", fa, "-k", str(K), "-r", kdb], stream=False)
    _, st, launches, wall, peak = counted_run(
        ["-t", "align", "-r", kdb, "--reads", fq, "-a", aln])
    if min(launches.values()) <= 0:
        raise AssertionError(f"32 Mbp align: a kernel never launched: {launches}")
    t0 = time.perf_counter()
    store = PseudoAlignment.load(aln)
    load_s = time.perf_counter() - t0
    n = int(gi.size)
    flat = np.concatenate(store._list_flat)
    if store._read_ids != [f"read_{i}" for i in range(n)]:
        raise AssertionError("32 Mbp align: read ids are not the input's, in order")
    if set(store._mtypes) != {1} or len(store._mtypes) != n:
        raise AssertionError("32 Mbp align: not every read is uniquely mapped")
    if set(store._list_counts) != {1} or not np.array_equal(flat, gi):
        raise AssertionError("32 Mbp align: a mapping list is not [its genome]")
    stats = store.get_summary()["Statistics"]
    if stats != {"unique_mapped_reads": n, "ambiguous_mapped_reads": 0,
                 "unmapped_reads": 0}:
        raise AssertionError(f"32 Mbp align: Statistics {stats}")
    say("phase 8b 32 Mbp align task, read store == truth read by read (%d reads): "
        "reference wall %.3f s (fasta %.3f s, host build %.3f s, .kdb write "
        "%.3f s), .kdb %d B; align wall %.3f s (.kdb load %.3f s, host "
        "16-slot table %.3f s, stream %.3f s = %.0f reads/s aligned, of it "
        "the read store's host work %.3f s, .aln write %.3f s), .aln %d B, "
        ".aln load %.3f s, %.0f B of mapping lists fetched per batch of %d, "
        "peak device memory %d B, launches %s" % (
            n, ref_wall, ref_st["fasta_parse"], ref_st["db_build"],
            ref_st["kdb_save"], os.path.getsize(kdb), wall, st["kdb_load"],
            st["table_build"], st["stream_align"], n / st["stream_align"],
            st["read_store"], st["aln_save"], os.path.getsize(aln), load_s,
            fetched_bytes_per_batch(store, n, BATCH), BATCH, peak, launches))
    os.remove(kdb)
    os.remove(aln)
    return launches


def phase_extsim(tmp: str, rng, device) -> None:
    """Phase 8c: EXTSIM's overlap matrix on the card against the host
    product at G = 512, then dumpref --filter-similar on the panel."""
    import torch

    from shotgun_tpu_torch.index.extsim import (
        _ident_pairs,
        overlap_matrix_device,
        overlap_matrix_host,
    )
    from shotgun_tpu_torch.reference import KmerReference
    from shotgun_tpu_torch.utils.synth import make_genomes, to_fasta

    panel = make_genomes(rng, EXT_GENOMES, EXT_LEN, EXT_ANCESTORS, MUTATION_RATE)
    index = KmerReference(K, panel).index
    idents, _, kmer_u, ident_u = _ident_pairs(index)
    g = len(idents)
    args = (kmer_u, ident_u, g, index.num_kmers)
    overlap_matrix_device(*args, device)  # warm-up: cuBLAS handle, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = overlap_matrix_device(*args, device)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = overlap_matrix_host(*args)
    host_s = time.perf_counter() - t0
    if dev.dtype != np.int64 or not np.array_equal(dev, host):
        raise AssertionError("EXTSIM: the device overlap matrix != the host's")
    fa = os.path.join(tmp, "ext.fa")
    with open(fa, "w") as fh:
        fh.write(to_fasta(panel))
    out = os.path.join(tmp, "ext_dumpref.json")
    _, st, _, wall, _ = counted_run(
        ["-t", "dumpref", "-g", fa, "-k", str(K), "--filter-similar",
         "--similarity-threshold", "0.5"], out_path=out, stream=False)
    with open(out) as fh:
        text = fh.read()
    # the Similarity report is the JSON's last member
    at = text.rindex('"Similarity": ') + len('"Similarity": ')
    sim = json.loads(text[at:].rstrip()[:-1])
    kept = sum(v["kept"] == "yes" for v in sim.values())
    if len(sim) != g or not 0 < kept < g:
        raise AssertionError(f"EXTSIM dumpref: {kept} of {len(sim)} genomes kept")
    say("phase 8c EXTSIM at G=%d (%d ancestors x %d copies of %d bp at %.1f%% "
        "mutation, %d distinct k-mers, %d (k-mer, genome) pairs): overlap matrix "
        "on the card == host product exactly, card %.3f ms vs host %.3f ms; "
        "dumpref --filter-similar --similarity-threshold 0.5: %d of %d kept, "
        "db build with EXTSIM %.3f s, dumpref %d B in %.3f s, wall %.3f s" % (
            g, EXT_ANCESTORS, EXT_GENOMES // EXT_ANCESTORS, EXT_LEN,
            100 * MUTATION_RATE, index.num_kmers, kmer_u.size, 1e3 * dev_s,
            1e3 * host_s, kept, g, st["db_build"], len(text), st["dumpref"], wall))
    os.remove(out)


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
        fa, fq = os.path.join(tmp, "m.fa"), os.path.join(tmp, "m.fq")
        write_workload(work, fa, fq)
        gi = work.genome_of
        del genomes, work
        launches = phase_main_path(fa, fq, gi)
        torch.cuda.empty_cache()

        # 6. strain panel on four routes
        sfa, sfq = os.path.join(tmp, "s.fa"), os.path.join(tmp, "s.fq")
        write_workload(strain_work, sfa, sfq)
        del strains, strain_work
        by_path = {"main path": launches, **phase_strains(sfa, sfq)}
        torch.cuda.empty_cache()

        # 7. goldens on the card, every route
        phase_goldens(tmp)

        # 8. the rest of the CLI at size
        by_path.update(phase_strain_files(tmp, sfa, sfq))
        torch.cuda.empty_cache()
        by_path["32 Mbp align"] = phase_main_files(tmp, fa, fq, gi)
        torch.cuda.empty_cache()
        phase_extsim(tmp, rng, device)
    torch.cuda.empty_cache()

    for kr in kernels:
        kr["launches"] = launches[kr["name"]]
        kr["launches_by_path"] = {p: n[kr["name"]] for p, n in by_path.items()}
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
