#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (shotgun_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each:
  1. device: the card's name and its power limit (nvidia-smi);
  2. build: the CUDA kernels from shotgun_tpu_torch/ops/kernels/csrc with
     nvcc, and the port's native host library (g++, build/host/), at
     once, timed; the loaded native library must be the port's;
  3. database build on the device against the host build, both timed, on
     the phase-5 genomes (32 Mbp) and the phase-6 strain panel: equal
     distinct keys, genome counts and set membership per key; then the
     device assembly of the 32 Mbp 16-slot hash table, timed;
  4. kernels against their plain PyTorch versions on the card, at the main
     path's shapes (B = 32768 reads, row stride 160, k = 31, the
     device-assembled 16-slot table of phase 3 with a stash of planted
     entries; and H1 on the packed 32 Mbp genome as one row, as the device
     build runs it), H2 also on the strain panel's 4-slot table (the
     `hash` route's, built here from phase 3's host index) with a batch of
     its reads, H1 at its edge shapes (k, rows, row widths, a row longer
     than a tile, each mode) and H2 at its own (4 and 16 slots, stashes of
     0, 1 and 64 rows, 1 to 257 probes, keys in the first and last slot,
     in the first and last bucket, twice in a row and in the stash, and
     each batch with one probe more): exact equality, and the time of each
     beside its plain version, its bytes and its byte bound at 3.35 TB/s;
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
and sums together); each timed mode carries its own main-path launches.
Kernel H2's entry likewise gives the 16-slot table (the main path's) and
the 4-slot one (launched on the `hash` routes) as two modes.
Each kernel's launches on every path (the main path and the four
strain-panel routes, each counted from 0) are listed too.  No single
PyTorch call computes either kernel's function, so ``library_ms`` is
null, with the reason beside it.
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
import threading
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
#: probe counts of H2's edge cases: a warp of one probe, a warp less one,
#: one warp, a warp and one, a block less one, a block and one
H2_EDGE_N = (1, 31, 32, 33, 255, 257)
#: an empty slot's set id in a hash table row
H2_EMPTY = np.uint32(0xFFFFFFFF)
PALLAS = "shotgun_tpu/ops/pallas/kernels.py"
CSRC = "shotgun_tpu_torch/ops/kernels/csrc"


def say(msg: str) -> None:
    print(msg, flush=True)


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


def timed(fn, plain, out_bytes: int, iters: int, plain_iters: int = 5):
    """(kernel ms, plain ms) on the card (``bench_encode.device_ms``: the
    launches queued behind a sleep kernel), the outputs kept alive over a
    rotation that passes the L2, so every launch writes to memory."""
    from shotgun_tpu_torch.tools.bench_encode import device_ms, rotation

    n = rotation(out_bytes)
    ring = [None] * n

    def keep(f):
        return lambda i: ring.__setitem__(i % n, f())

    ms = device_ms(keep(fn), iters)
    ring[:] = [None] * n
    plain_ms = device_ms(keep(plain), plain_iters)
    ring[:] = [None] * n
    return ms, plain_ms


def h1_edge_checks(rng, device) -> tuple:
    """H1 against its plain version at the edge shapes: k in {1, 2, 15,
    31}; 1, 7 and 32768 rows of 8, 40 and 41 packed bytes; a single row
    one window longer than a tile; keys only, sums only and both; sums
    only at a row length that is no multiple of 4.  Rows are zero past a
    random length, as the native fill pads them.  (cases, max |err|)."""
    import torch

    from shotgun_tpu_torch.ops.encode import H1_SPAN, encode_window, encode_window_plain

    def padded(rows, length, lo, hi):
        x = rng.integers(lo, hi, size=(rows, length), dtype=np.uint8)
        x[np.arange(length)[None, :] >= rng.integers(length // 2, length + 1,
                                                     size=rows)[:, None]] = 0
        return torch.from_numpy(x).to(device)

    cases, worst = 0, 0
    for k in (1, 2, 15, 31):
        tile_row = (H1_SPAN - 64 + k + 3) // 4  # W = tile + 1..4 windows
        shapes = [(r, w) for r in (1, 7, 32768) for w in (8, 40, 41)] + [(1, tile_row)]
        for rows, width in shapes:
            packed = padded(rows, width, 0, 256)
            qual = padded(rows, 4 * width, 33, 127)
            for args in ((packed, k, None), (None, k, qual), (packed, k, qual)):
                worst = max(worst, max_abs_err(
                    [x for x in encode_window(*args) if x is not None],
                    [x for x in encode_window_plain(*args) if x is not None]))
                cases += 1
        qual = padded(7, 163, 33, 127)
        worst = max(worst, max_abs_err([encode_window(None, k, qual)[1]],
                                       [encode_window_plain(None, k, qual)[1]]))
        cases += 1
    torch.cuda.synchronize()
    return cases, worst


def _random_keys(rng, n: int) -> np.ndarray:
    keys = np.unique(rng.integers(0, 1 << 62, size=n, dtype=np.int64))
    return keys[rng.permutation(keys.size)]


def _words(keys: np.ndarray) -> tuple:
    return (keys & 0xFFFFFFFF).astype(np.uint32), (keys >> 32).astype(np.uint32)


def _row(key, sid, gc) -> np.ndarray:
    lo, hi = _words(np.array([key], dtype=np.int64))
    return np.array([lo[0], hi[0], sid, gc], dtype=np.uint32)


def edge_table(rng: np.random.Generator, slots: int, n_base: int = 2000) -> tuple:
    """A small table of ``slots`` slots a bucket, built by
    ``build_probe_table`` from random keys, with the edges H2 must get
    right: (table uint32 [nb, slots, 4], stash uint32 [64, 4], the special
    keys int64).  The special keys sit in the first and the last slot of a
    full bucket whose overflow goes to the stash, in buckets 0 and nb - 1,
    twice in one row, twice in the stash beside a table match, twice in the
    stash alone, and in the stash alone; the stash is filled to 64 rows
    with keys that nothing probes."""
    from shotgun_tpu_torch.index.hashtable import _TARGET_LAMBDA, _next_pow2, build_probe_table
    from shotgun_tpu_torch.ops.encode import mix32_np
    from shotgun_tpu_torch.ops.probe import STASH_CAP

    base = _random_keys(rng, n_base)
    nb = _next_pow2(max(int((n_base + slots + 6) / _TARGET_LAMBDA[slots]), 1))
    cand = _random_keys(rng, 1 << 21)
    bucket = mix32_np(*_words(cand)) & np.uint32(nb - 1)
    inner = bucket[(bucket != 0) & (bucket != nb - 1)][0]
    full = cand[bucket == inner][: slots + 4]       # a full row + 4 overflow keys
    ends = np.concatenate([cand[bucket == 0][:1], cand[bucket == nb - 1][:1]])
    keys = np.unique(np.concatenate([base, full, ends]))
    keys = keys[rng.permutation(keys.size)]
    lo, hi = _words(keys)
    pt = build_probe_table(lo, hi, rng.integers(0, 1 << 20, size=keys.size),
                           rng.integers(1, 6, size=keys.size), slots_per_bucket=slots)
    assert pt.n_buckets == nb and pt.stash.shape[0] >= 4
    table = pt.table.copy()

    def key_at(b: int, s: int) -> int:
        return int(table[b, s, 0]) | int(table[b, s, 1]) << 32

    specials = [key_at(inner, 0), key_at(inner, slots - 1), *ends]
    # a key twice in one row: a copy in the row's last free slot, with a
    # lower set id and a higher genome count, so min/max/min mix the two
    for b in (0, nb - 1, *np.unique(mix32_np(lo, hi) & np.uint32(nb - 1))):
        free = np.flatnonzero(table[b, :, 2] == H2_EMPTY)
        if free.size and free[0] > 0:
            break
    assert free.size and free[0] > 0, "no row with a key and a free slot"
    dup = key_at(b, 0)
    table[b, free[-1]] = _row(dup, table[b, 0, 2] // 2, table[b, 0, 3] + 3)
    over = int(pt.stash[0, 0]) | int(pt.stash[0, 1]) << 32
    alone = int(_random_keys(rng, 1)[0])
    tsid, tgc = table[0, 0, 2], table[0, 0, 3]
    rows = [_row(ends[0], tsid + 1, tgc + 2), _row(ends[0], tsid // 3, 1),
            _row(over, 7, 9), _row(alone, 5, 2)]
    specials += [dup, over, alone]
    filler = _random_keys(rng, STASH_CAP)
    rows += [_row(k, i, 1) for i, k in enumerate(filler)]
    stash = np.concatenate([pt.stash, np.stack(rows)])[:STASH_CAP]
    return table, stash, np.array(specials, dtype=np.int64)


def edge_queries(rng: np.random.Generator, table: np.ndarray, specials: np.ndarray,
                 n: int) -> np.ndarray:
    """``n`` int64 query keys: the special keys first, then keys of the
    table and keys it lacks."""
    held = table[table[..., 2] != H2_EMPTY]
    present = held[:, 0].astype(np.int64) | held[:, 1].astype(np.int64) << 32
    rest = np.where(rng.random(n) < 0.6, rng.choice(present, size=n),
                    rng.integers(0, 1 << 62, size=n))
    return np.concatenate([specials, rest])[:n]


def h2_edge_checks(rng, device) -> tuple:
    """H2 against its plain version at the edge shapes: 4 and 16 slots;
    stashes of 0, 1 and 64 rows; n in H2_EDGE_N probes (a warp of one
    probe, warps cut short or full, a block and a warp more or less).  The
    tables (``edge_table``) hold keys in the first and the
    last slot of a full bucket, in buckets 0 and n_buckets - 1, twice in
    one row and twice in the stash; the queries start with those keys.
    (cases, max |err|)."""
    import torch

    from shotgun_tpu_torch.ops.probe import hash_probe, hash_probe_plain

    cases, worst = 0, 0
    for slots in (4, 16):
        table, stash, specials = edge_table(rng, slots)
        table_d = torch.from_numpy(table.view(np.int32)).to(device)
        for stash_n in (0, 1, 64):
            stash_d = torch.from_numpy(stash[:stash_n].view(np.int32)).to(device)
            for n in H2_EDGE_N:
                keys = torch.from_numpy(edge_queries(rng, table, specials, n)).to(device)
                worst = max(worst, max_abs_err(hash_probe(table_d, stash_d, keys),
                                               hash_probe_plain(table_d, stash_d, keys)))
                cases += 1
    torch.cuda.synchronize()
    return cases, worst


def phase_kernels(tab, strain_index, codes: np.ndarray, strain_codes: np.ndarray,
                  genomes, rng, device) -> list:
    """Phase 4: each kernel against its plain version at main-path shapes
    (and at its edge shapes), timed beside its byte bound; H2 also on the
    strain panel's 4-slot table, built here from its host index."""
    import torch

    from shotgun_tpu_torch.index.device_build import _host_prep
    from shotgun_tpu_torch.index.hashtable import build_probe_table
    from shotgun_tpu_torch.ops.encode import (
        encode_window,
        encode_window_plain,
        pack_codes_2bit,
    )
    from shotgun_tpu_torch.ops.probe import (
        STASH_POS_BASE,
        hash_probe,
        hash_probe_plain,
        hash_table_to_device,
    )
    from shotgun_tpu_torch.tools.bench_encode import bound_ms, h1_bytes
    from shotgun_tpu_torch.tools.bench_probe import probe_case

    n_edge, err_edge = h1_edge_checks(rng, device)
    n_h2_edge, err_h2_edge = h2_edge_checks(rng, device)
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
    del row_keys, row_keys_p, kq, kq_p

    if max(err_edge, err_enc, err_qual, err_h2_edge) != 0:
        raise AssertionError(f"kernel != plain: encode edges {err_edge}, encode "
                             f"{err_enc}, encode+qual {err_qual}, probe edges "
                             f"{err_h2_edge}")

    # H2: the device-assembled 16-slot table of phase 3 and the strain
    # panel's 4-slot table, each probed with one batch of its reads (the
    # batch, and the batch plus one key: a last warp of one probe)
    t0 = time.perf_counter()
    pt = build_probe_table(strain_index.kmer_lo, strain_index.kmer_hi,
                           strain_index.set_id, strain_index.genome_counts(),
                           slots_per_bucket=4)
    tab4 = hash_table_to_device(pt.table, pt.stash, device)
    torch.cuda.synchronize()
    table4_s = time.perf_counter() - t0
    del pt
    h2_modes = []
    for case in (probe_case("16-slot", tab.table, tab.stash, codes, rng),
                 probe_case("4-slot", tab4.table, tab4.stash, strain_codes, rng)):
        args = (case["table"], case["stash"])
        flat = case["keys"].reshape(-1)
        plus_one = torch.cat([flat, flat[-1:]])
        probe = hash_probe(*args, case["keys"])
        err = max(max_abs_err(probe, hash_probe_plain(*args, case["keys"])),
                  max_abs_err(hash_probe(*args, plus_one),
                              hash_probe_plain(*args, plus_one)))
        torch.cuda.synchronize()
        stash_hits = int((probe[2] >= STASH_POS_BASE).sum().item())
        if err != 0:
            raise AssertionError(f"kernel != plain: probe {case['name']} {err}")
        if stash_hits == 0:
            raise AssertionError(f"{case['name']}: no window resolved through "
                                 "the planted stash")
        del probe, plus_one
        n = case["keys"].numel()
        ms, plain_ms = timed(lambda: hash_probe(*args, case["keys"]),
                             lambda: hash_probe_plain(*args, case["keys"]), n * 12, 100)
        h2_modes.append({
            "shape": f"{n} probes into {tuple(case['table'].shape)}",
            "mode": case["name"], "bytes": case["bytes"],
            "bound_ms": bound_ms(case["bytes"]),
            "bound_share": bound_ms(case["bytes"]) / ms, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "max_abs_err": err,
            "distinct_buckets": case["buckets"], "stash_rows": case["stash"].shape[0],
            "stash_hits": stash_hits})
    del tab4, case, args
    nwin = LPAD - K + 1
    h1_modes = [
        # (shape, mode, bytes, kernel, plain, output bytes)
        (f"[{b}, {LPAD}]", "keys+sums", h1_bytes(b, LPAD // 4, K, True, True),
         lambda: encode_window(packed_d, K, qual_d),
         lambda: encode_window_plain(packed_d, K, qual_d), b * nwin * 12),
        (f"[{b}, {LPAD}]", "keys", h1_bytes(b, LPAD // 4, K, True, False),
         lambda: encode_window(packed_d, K), lambda: encode_window_plain(packed_d, K),
         b * nwin * 8),
        (f"[1, {row_d.shape[1] * 4}] (genome as one row)", "keys, one row",
         h1_bytes(1, row_d.shape[1], K, True, False),
         lambda: encode_window(row_d, K), lambda: encode_window_plain(row_d, K),
         (row_d.shape[1] * 4 - K + 1) * 8),
    ]
    modes = []
    for shape, mode, nbytes, fn, plain, out_bytes in h1_modes:
        ms, plain_ms = timed(fn, plain, out_bytes, 200)
        modes.append({"shape": shape, "mode": mode, "bytes": nbytes,
                      "bound_ms": bound_ms(nbytes), "bound_share": bound_ms(nbytes) / ms,
                      "ms": ms, "plain_ms": plain_ms, "library_ms": None})
    no_library = ("none: no single PyTorch call computes this function (%s); "
                  "the plain version takes %s")
    main_mode = modes[0]
    results = [
        {"name": "encode_window", "route": "cuda",
         "source": f"{CSRC}/encode_window.cu", "replaces": f"{PALLAS}:74",
         "also_replaces": f"{PALLAS}:107", "max_abs_err": max(err_edge, err_enc, err_qual),
         "ms": main_mode["ms"], "plain_ms": main_mode["plain_ms"],
         "bound_ms": main_mode["bound_ms"], "bound_by": "bytes",
         "bound_share": main_mode["bound_share"], "bytes": main_mode["bytes"],
         "library_ms": None,
         "library_reason": no_library % (
             "2-bit unpack, k-mer encode and window quality sums in one pass",
             "an unpack, k shift-or steps and a cumsum"),
         "edge_cases_checked": n_edge, "modes": modes},
        {"name": "hash_probe", "route": "cuda",
         "source": f"{CSRC}/hash_probe.cu", "replaces": f"{PALLAS}:162",
         "max_abs_err": max(err_h2_edge, *(m["max_abs_err"] for m in h2_modes)),
         **{key: h2_modes[0][key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_share", "bytes", "distinct_buckets")},
         "bound_by": "bytes", "library_ms": None,
         "library_reason": no_library % (
             "bucket hash, bucket-row gather, slot and stash compare",
             "a gather and min/max reductions"),
         "edge_cases_checked": n_h2_edge, "modes": h2_modes},
    ]
    say("phase 4 kernels == plain (integer outputs, tolerance 0): H1 at %d edge "
        "cases (k 1/2/15/31; 1, 7, 32768 rows of 8/40/41 packed bytes; a row one "
        "tile long; keys, sums, both) and at B=%d L=%d k=%d, and on the genome as "
        "one row of %d bases; H2 at %d edge cases (4 and 16 slots; stash 0/1/64 "
        "rows; n %s) and on one batch of B=%d reads (and one window more) on the "
        "device-assembled 16-slot table of phase 3 and on the strain panel's "
        "4-slot table (host "
        "build %.3f s). Times (launches queued behind a sleep kernel, outputs "
        "rotated past the L2): %s" % (
            n_edge, b, LPAD, K, row_d.shape[1] * 4, n_h2_edge,
            "/".join(map(str, H2_EDGE_N)), b, table4_s,
            "; ".join("%s %s %s %.4f ms vs plain %.4f ms, %d B, bound %.4f ms, "
                      "%.1f%% of it%s" % (
                          kernel, m["mode"], m["shape"], m["ms"], m["plain_ms"],
                          m["bytes"], m["bound_ms"], 100 * m["bound_share"],
                          ", %d distinct buckets read, stash %d rows, %d stash hits" % (
                              m["distinct_buckets"], m["stash_rows"], m["stash_hits"])
                          if kernel == "H2" else "")
                      for kernel, ms_list in (("H1", modes), ("H2", h2_modes))
                      for m in ms_list)))
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
    encode_window.launches_by_mode.clear()
    hash_probe.launches = 0
    hash_probe.launches_by_mode.clear()
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
    the device; returns that table and the last panel's host index."""
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
        del built
    say("phase 3 db build device == host (keys, genome counts, membership): "
        + "; ".join(parts))
    return table, host


def phase_main_path(fa: str, fq: str, gi: np.ndarray) -> tuple:
    """Phase 5: dumpalign through the CLI, held against the known truth;
    returns each kernel's launch count in that run, and by mode."""
    from shotgun_tpu_torch.io import native_available
    from shotgun_tpu_torch.ops.encode import encode_window
    from shotgun_tpu_torch.ops.probe import hash_probe

    if not native_available():
        raise AssertionError("the native FASTQ library did not build")
    out, stages, launches, wall, peak = counted_run(
        ["-t", "dumpalign", "-g", fa, "-k", str(K), "--reads", fq,
         "--min-kmer-quality", str(MKQ)])
    by_mode = {"encode_window": dict(encode_window.launches_by_mode),
               "hash_probe": dict(hash_probe.launches_by_mode)}
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
        "aligned, %.0f reads/s wall, peak device memory %d B, launches %s "
        "(by mode %s); summary == truth" % (
            n, N_GENOMES, GENOME_LEN, K, wall, stages.get("fasta_parse", 0.0),
            stages["db_build_device"], stages.get("table_build", 0.0),
            align_s, n / align_s, n / wall, peak, launches, by_mode))
    return launches, by_mode


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
    from shotgun_tpu_torch.io import native
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

    # 2. build: the native host library (g++) beside the CUDA kernels (nvcc)
    t0 = time.perf_counter()
    host_build = threading.Thread(target=native.build_library)
    host_build.start()
    built = build(force=True)
    load_library()
    host_build.join()
    lib_path = native.library_path()
    want_path = os.path.join(HERE, "build", "host", os.path.basename(native.LIB_PATH))
    if lib_path != want_path:
        raise AssertionError(f"native library {lib_path}, not the port's {want_path}")
    say(f"phase 2 build: nvcc sm_90a, {len(built.log.splitlines())} ptxas "
        f"lines, {built.seconds:.3f} s; the port's native library {lib_path} "
        f"loaded; both built in {time.perf_counter() - t0:.3f} s")
    print(built.log, file=sys.stderr, flush=True)

    # data for phases 3 to 6
    rng = np.random.default_rng(args.seed)
    genomes = synth_genomes(rng, N_GENOMES, GENOME_LEN)
    work = sample_reads(rng, genomes, N_READS, READ_LEN)
    strains = make_genomes(rng, N_GENOMES, STRAIN_LEN, STRAINS, MUTATION_RATE)
    strain_work = sample_reads(rng, strains, N_READS, READ_LEN, ERROR_RATE)

    # 3. database build, device against host; 4. kernels against plain
    tab, strain_index = phase_db_build([("32 Mbp main-path genomes", genomes),
                                        ("strain panel", strains)], device)
    kernels = phase_kernels(tab, strain_index, work.codes[:BATCH],
                            strain_work.codes[:BATCH], genomes, rng, device)
    del tab, strain_index
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # 5. main path
        fa, fq = os.path.join(tmp, "m.fa"), os.path.join(tmp, "m.fq")
        write_workload(work, fa, fq)
        gi = work.genome_of
        del genomes, work
        launches, by_mode = phase_main_path(fa, fq, gi)
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
        for m in kr["modes"]:
            m["launches_main_path"] = by_mode[kr["name"]].get(m["mode"], 0)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
