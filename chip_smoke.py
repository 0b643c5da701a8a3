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
     each batch with one probe more), and H1's multi-word composition
     (``encode_words``: H1 at k = 31 and at k mod 31, sliced and summed)
     at k in WORD_KS on the main path's batch and at ragged shapes: exact
     equality, and the time of each (the composition at k = 75) beside its
     plain version, its bytes and its byte bound at 3.35 TB/s;
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
     dumpalign -a, which must print the plain case; then the 4 runlog
     dumpalign cases at k = 75 and 150 (multi-word keys: the word sort
     join, H1 launched and H2 not);
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
        on the panel through the CLI, which must drop genomes;
  9. multi-word keys at size: `-t dumpalign -g -k 75 --reads` on the strain
     panel of phase 6 (host build, word sort join): once on phase 6's reads
     (all 'I'), and once on the same reads with random qualities (from
     --seed, raw bytes uniform in WORD_QUAL) and --min-kmer-quality
     WORD_MKQ, which filters about half the windows: H1 launched and H2
     not, the statistics sum to the reads with unique and ambiguous reads
     both present, the gated run's filtered_quality_kmers equal to the
     windows whose quality sum numpy finds below the gate, and its mapped
     counts other than the ungated run's; then reference -k 75 -> align
     -r -> dumpalign -a equal to dumpalign -r --reads and to dumpalign -g;
     the first BATCH gated reads through the port on the CPU (plain
     versions, asked for by SHOTGUN_TPU_TORCH_DEVICE) equal to the card's;
     stages, reads/s and peak device memory printed;
 10. the library's ``align_packed_reads`` on the golden corpus on the sort
     join, the 4-slot hash (H2) and at k = 35 (the word join): its summary
     and read store equal ``align_stream``'s and the summary the plain
     case's at k = 11;
 11. the multi-device paths (``shotgun_tpu_torch.parallel``) on the card, at
     the sizes of phases 5 and 6, several shards on cuda:0:
     a. data parallel: ``align_packed_reads`` of phase 5's 524,288 reads
        (parsed from its FASTQ) over ``make_mesh([cuda:0] * 4)`` against a
        device build of its 32 Mbp genomes (the 16-slot table, H2), with
        phase 5's MKQ gate: the summary equal to phase 5's stdout;
     b. the same on the strain panel over 8 shards (the sort join), equal to
        phase 6's stdout;
     c. DP x TP: a 2 x 2 mesh with the sort table split in 2 key ranges, on
        the strain panel and on the 32 Mbp genomes (SHOTGUN_TPU_PROBE=sort,
        31,999,040 rows), each equal to its single-device run; one batch's
        ms (CUDA events around back-to-back batches) beside the
        single-device sort join's;
     d. two CLI processes (SHOTGUN_TPU_NPROCS=2) of `-t dumpalign -g -k 31`
        on the strain panel, both on cuda:0 over gloo: process 0's stdout
        ends in phase 6's, process 1 prints no summary;
     e. ``tools/dryrun.py dryrun_multichip(4)``.
     Each path's wall, reads/s, peak device memory and kernel launches;
 12. 100 Mbp, the JAX repo's proven scale (``tools/devbuild_proof.py`` and
     ``tools/bulk_proof.py`` at their defaults):
     a. 64 random genomes of 1.5625 Mbp built on the card (at least
        P12_MIN_KEYS distinct 31-mers; the auto table under the default
        budget printed), 262,144 reads at B = P12_BATCH, the cross-check
        against the host build; the same genomes built again with
        $SHOTGUN_TPU_HASH_HBM_BUDGET at P12_BUDGET, so that the 16-slot
        table of P12_BUCKETS buckets exists: its summary equal to the
        first's, H2 launched; each route's reads/s, device ms a batch and
        idle share (``tools/profile_align.py``'s measures); H1 on the genome
        as one row and H2 on that table against their plain versions;
     b. part a: 16 random genomes of 6.25 Mbp built on the host, the sort
        table uploaded, 1,048,576 reads as a FASTQ streamed twice on the
        auto route (the host-built 16-slot table), 64 sampled reads against
        ``Read.pseudo_align``; the reference saved as a .kdb and `-t
        dumpalign -r` of it on the FASTQ in a child process, whose stdout
        must equal the library's summary (its kdb_load, table_build and
        stream_align stages printed); the host's RAM and the free disk
        (P12_DISK needed) first;
     c. part b: k = 75 at 16.8M keys, the sharded probe on a 1 x 1 mesh
        equal to the unsharded one.
     Each stage's wall, peak device memory, peak resident memory of this
     process (and of 12b's child, sampled from outside), and kernel
     launches.

 13. the port's benchmark and profilers (``shotgun_tpu_torch/tools/``), each
     in a child process on the card: ``bench`` at its defaults (the JAX
     repo's BASELINE workload: 5 x 200 kbp, 524,288 error-free reads at
     B = 32768, the sort join) and with ``--probe hash16 --devbuild-mbp 0``:
     the stream's statistics sum to the reads, the staged totals and the
     align task's summary equal the stream's, every rate is positive, H1
     (and H2 on hash16) launched once a staged batch; then
     ``profile_stages`` on the sort and hash16 routes and
     ``profile_devbuild 1 32``.  Each one's figures, and the phase's time.

Then one JSON line of per-kernel results and, last, the device line.  Any
failure raises and exits non-zero; so does a machine without CUDA, and a
directory that holds this script without the package.  Nothing here
imports the JAX package: data, reference and profiler come through
shotgun_tpu_torch.

Kernel H1 (encode_window) replaces two TPU kernels, the rolling encode and
the quality sums, in one launch; its entry gives the time of each mode,
and its launch count is that of every H1 launch on the main path (the
device build's window encode and the batches, with the MKQ gate, so keys
and sums together); each timed mode carries its own main-path launches,
and the multi-word mode the H1 launches of phase 9's MKQ run, its path.
Kernel H2's entry likewise gives the 16-slot table (the main path's) and
the 4-slot one (launched on the `hash` routes) as two modes.  Phase 12
adds a mode to each: H1 on the 100 Mbp genome row and H2 on its 2^25-bucket
table, with their launches on 12a's hash16 path (build, assembly, align).
Each kernel's launches on every path (the main path, the strain-panel
routes, the later phases' runs, phase 11's mesh paths, phase 12's
stages and the staged batches of phase 13's bench runs, each counted from
0) are listed too.  No single
PyTorch call computes either kernel's function, so ``library_ms`` is
null, with the reason beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
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

from shotgun_tpu_torch.utils.synth import (
    ERROR_RATE,
    MUTATION_RATE,
    READ_LEN,
    STRAIN_ANCESTORS,
    STRAIN_GENOMES,
    STRAIN_LEN,
)

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
#: multi-word keys: the k of H1's composition checks, the timed k and the
#: k of phase 9
WORD_KS = (32, 62, 64, 75, 93, 150)
K_WORDS = 75
#: phase 9's gated run: raw quality bytes uniform in WORD_QUAL (mean 53),
#: and an MKQ gate at that mean, so about half the 75-base windows fail it
WORD_QUAL = (33, 73)
WORD_MKQ = 53
RUNLOG = os.path.join(GOLDEN, "runlog")
#: the runlog dumpalign cases of multi-word keys (k = 75 and 150)
RUNLOG_WORD_CASES = ["rl-small-k75-m1p1", "rl-small-k75-m5p5",
                     "rl-mid-k150-flags", "rl-mid-k150-mg0"]
#: phase 12: the proofs' batch; the least distinct 31-mers of its 100 Mbp
#: builds; the buckets of their 16-slot table (8.6 GB) and the device budget
#: of 12a's second route, which holds it; the free bytes 12b needs for its
#: FASTQ (~0.33 GB) and .kdb (~4 GB)
P12_BATCH = 16384
P12_MIN_KEYS = 99_000_000
P12_BUCKETS = 1 << 25
P12_BUDGET = 16_000_000_000
P12_DISK = 6_000_000_000
PALLAS = "shotgun_tpu/ops/pallas/kernels.py"
CSRC = "shotgun_tpu_torch/ops/kernels/csrc"


def say(msg: str) -> None:
    print(msg, flush=True)


def reset_launches() -> None:
    from shotgun_tpu_torch.ops.encode import encode_window
    from shotgun_tpu_torch.ops.probe import hash_probe

    encode_window.launches = hash_probe.launches = 0


def read_launches() -> dict:
    from shotgun_tpu_torch.ops.encode import encode_window
    from shotgun_tpu_torch.ops.probe import hash_probe

    return {"encode_window": encode_window.launches, "hash_probe": hash_probe.launches}


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
    """(kernel ms, plain ms) on the card (``bench_encode.kept_ms``: the
    launches queued behind a sleep kernel, the outputs kept alive over a
    rotation that passes the L2, so every launch writes to memory)."""
    from shotgun_tpu_torch.tools.bench_encode import kept_ms

    return kept_ms(fn, out_bytes, iters), kept_ms(plain, out_bytes, plain_iters)


def padded_rows(rng, device, rows: int, length: int, lo: int, hi: int):
    """uint8 [rows, length] of values in [lo, hi) on ``device``, zero past
    a random length, as the native fill pads its rows."""
    import torch

    x = rng.integers(lo, hi, size=(rows, length), dtype=np.uint8)
    x[np.arange(length)[None, :] >= rng.integers(length // 2, length + 1,
                                                 size=rows)[:, None]] = 0
    return torch.from_numpy(x).to(device)


def h1_edge_checks(rng, device) -> tuple:
    """H1 against its plain version at the edge shapes: k in {1, 2, 15,
    31}; 1, 7 and 32768 rows of 8, 40 and 41 packed bytes; a single row
    one window longer than a tile; keys only, sums only and both; sums
    only at a row length that is no multiple of 4.  Rows are zero past a
    random length, as the native fill pads them.  (cases, max |err|)."""
    import torch

    from shotgun_tpu_torch.ops.encode import H1_SPAN, encode_window, encode_window_plain

    def padded(rows, length, lo, hi):
        return padded_rows(rng, device, rows, length, lo, hi)

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


def h1_word_checks(rng, packed_d, qual_d, device) -> tuple:
    """H1's multi-word composition (``encode_words`` on the card) against
    ``encode_words_plain``, keys only and with sums, at every k of WORD_KS:
    on the main path's batch, and on 1 and 7 rows of ceil(k / 4), + 1, + 3
    and 41 packed bytes and one row a tile long.  (cases, max |err|)."""
    import torch

    from shotgun_tpu_torch.ops.encode import H1_SPAN, encode_words, encode_words_plain

    def flat(out):
        words, sums = out
        return list(words) + ([sums] if sums is not None else [])

    cases, worst = 0, 0
    for k in WORD_KS:
        first = -(-k // 4)
        inputs = [(packed_d, qual_d)]
        for rows, width in [(r, w) for r in (1, 7) for w in (first, first + 1, first + 3, 41)
                            ] + [(1, (H1_SPAN - 64 + k + 3) // 4)]:
            inputs.append((padded_rows(rng, device, rows, width, 0, 256),
                           padded_rows(rng, device, rows, 4 * width, 33, 127)))
        for packed, qual in inputs:
            for q in (None, qual):
                worst = max(worst, max_abs_err(flat(encode_words(packed, k, q)),
                                               flat(encode_words_plain(packed, k, q))))
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
        encode_words,
        encode_words_plain,
        pack_codes_2bit,
        word_spans,
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
    n_word, err_word = h1_word_checks(rng, packed_d, qual_d, device)

    if max(err_edge, err_enc, err_qual, err_h2_edge, err_word) != 0:
        raise AssertionError(f"kernel != plain: encode edges {err_edge}, encode "
                             f"{err_enc}, encode+qual {err_qual}, probe edges "
                             f"{err_h2_edge}, multi-word encode {err_word}")

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
    # the multi-word composition: packed codes and quality in, the words
    # (int64) and sums (int32) of every window out
    wwin, nwords = LPAD - K_WORDS + 1, len(word_spans(K_WORDS))
    word_out = b * wwin * (8 * nwords + 4)
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
        (f"[{b}, {LPAD}]", f"words k={K_WORDS}, keys+sums",
         b * (LPAD // 4 + LPAD) + word_out,
         lambda: encode_words(packed_d, K_WORDS, qual_d),
         lambda: encode_words_plain(packed_d, K_WORDS, qual_d), word_out),
    ]
    modes = []
    for shape, mode, nbytes, fn, plain, out_bytes in h1_modes:
        # a composition call costs the host far more than one H1 launch:
        # 32 of them are queued within the sleep kernel's ~10 ms, so its
        # loop stays device-paced
        ms, plain_ms = timed(fn, plain, out_bytes, 32 if mode.startswith("words") else 200)
        modes.append({"shape": shape, "mode": mode, "bytes": nbytes,
                      "bound_ms": bound_ms(nbytes), "bound_share": bound_ms(nbytes) / ms,
                      "ms": ms, "plain_ms": plain_ms, "library_ms": None})
    no_library = ("none: no single PyTorch call computes this function (%s); "
                  "the plain version takes %s")
    main_mode = modes[0]
    results = [
        {"name": "encode_window", "route": "cuda",
         "source": f"{CSRC}/encode_window.cu", "replaces": f"{PALLAS}:74",
         "also_replaces": f"{PALLAS}:107",
         "max_abs_err": max(err_edge, err_enc, err_qual, err_word),
         "ms": main_mode["ms"], "plain_ms": main_mode["plain_ms"],
         "bound_ms": main_mode["bound_ms"], "bound_by": "bytes",
         "bound_share": main_mode["bound_share"], "bytes": main_mode["bytes"],
         "library_ms": None,
         "library_reason": no_library % (
             "2-bit unpack, k-mer encode and window quality sums in one pass",
             "an unpack, k shift-or steps and a cumsum"),
         "edge_cases_checked": n_edge, "word_cases_checked": n_word, "modes": modes},
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
        "one row of %d bases; H1's multi-word composition at %d cases (k %s; the "
        "batch, 1 and 7 ragged rows, a row a tile long; keys, keys and sums); "
        "H2 at %d edge cases (4 and 16 slots; stash 0/1/64 "
        "rows; n %s) and on one batch of B=%d reads (and one window more) on the "
        "device-assembled 16-slot table of phase 3 and on the strain panel's "
        "4-slot table (host "
        "build %.3f s). Times (launches queued behind a sleep kernel, outputs "
        "rotated past the L2): %s" % (
            n_edge, b, LPAD, K, row_d.shape[1] * 4, n_word,
            "/".join(map(str, WORD_KS)), n_h2_edge,
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
    """The port's CLI in process, with the route variables and any other
    of ``env`` set to ``env`` for the call; stdout goes to ``out_path``
    when given (and "" is returned)."""
    from shotgun_tpu_torch.cli import main as cli_main

    saved = {name: os.environ.pop(name, None) for name in ROUTE_ENV + tuple(env or ())}
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
    reset_launches()
    encode_window.launches_by_mode.clear()
    hash_probe.launches_by_mode.clear()
    t0 = time.perf_counter()
    out = run_cli(argv + ["--profile"], env, out_path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
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
    returns each kernel's launch count in that run, and by mode, its
    stdout and its peak device memory."""
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
    return launches, by_mode, out, peak


def phase_strains(fa: str, fq: str) -> tuple:
    """Phase 6: the strain panel through the CLI on four routes, byte-equal;
    returns each route's kernel launches and the summary."""
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
        "%d routes, %s; %s" % (STRAIN_GENOMES, STRAIN_ANCESTORS,
                               STRAIN_GENOMES // STRAIN_ANCESTORS, STRAIN_LEN,
                               100 * MUTATION_RATE, N_READS, 100 * ERROR_RATE,
                               len(routes), stats, "; ".join(parts)))
    return by_route, outs[0]


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
    from shotgun_tpu_torch.ops.encode import encode_window
    from shotgun_tpu_torch.ops.probe import hash_probe

    with open(os.path.join(RUNLOG, "manifest.json")) as fh:
        runlog = json.load(fh)
    data = os.path.join(RUNLOG, "data") + "/"
    for case in RUNLOG_WORD_CASES:
        argv = [a.replace("data/", data) for a in runlog[case]["args"]]
        encode_window.launches = hash_probe.launches = 0
        out = run_cli(argv + ["--batch-size", "512"])
        with gzip.open(os.path.join(RUNLOG, f"{case}.out.gz"), "rt") as fh:
            if out != fh.read():
                raise AssertionError(f"runlog golden {case}: output differs")
        if encode_window.launches <= 0 or hash_probe.launches != 0:
            raise AssertionError(f"runlog golden {case}: H1 {encode_window.launches} "
                                 f"launches, H2 {hash_probe.launches}")
    say(f"phase 7 goldens: {len(GOLDEN_CASES)} dumpalign and {len(DUMPREF_CASES)} "
        "dumpref cases byte-equal on the card, and reference -> align -> "
        "dumpalign -a equal to the plain case, on each route: "
        f"{', '.join(r for r, _ in GOLDEN_ROUTES)}; the runlog dumpalign cases of "
        f"multi-word keys byte-equal on the auto route: {', '.join(RUNLOG_WORD_CASES)}")


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


def low_quality_windows(qual: np.ndarray, k: int, mkq: int) -> int:
    """Windows of k bases whose raw quality sum is below ``mkq * k``, over
    every row of ``qual`` (the MKQ gate's filtered_quality_kmers)."""
    cs = np.zeros((qual.shape[0], qual.shape[1] + 1), dtype=np.int32)
    np.cumsum(qual, axis=1, dtype=np.int32, out=cs[:, 1:])
    return int(((cs[:, k:] - cs[:, :-k]) < mkq * k).sum())


def phase_words(tmp: str, fa: str, fq: str, fq_q: str, fq_q_head: str,
                qual: np.ndarray) -> dict:
    """Phase 9: the strain panel at k = K_WORDS (multi-word keys) through
    the CLI, held against its own invariants, the gate's count from numpy,
    the file round trip and the CPU; ``fq_q`` holds ``fq``'s reads with
    the qualities ``qual`` and ``fq_q_head`` its first BATCH reads.
    Returns each run's kernel launches."""
    k = str(K_WORDS)
    gate = ["--min-kmer-quality", str(WORD_MKQ)]
    runs = (("no gate", fq, []), (f"random quality, MKQ {WORD_MKQ}", fq_q, gate))
    outs, parts, by_path = [], [], {}
    for name, reads, flags in runs:
        out, st, launches, wall, peak = counted_run(
            ["-t", "dumpalign", "-g", fa, "-k", k, "--reads", reads] + flags)
        # the device build declines k > 31 (stage db_build_device, empty),
        # and the host builds
        if "db_build" not in st or st.get("db_build_device", 0.0) > 0.1:
            raise AssertionError(f"k={k} {name}: not the host build: {st}")
        if launches["encode_window"] <= 0 or launches["hash_probe"] != 0:
            raise AssertionError(f"k={k} {name}: launches {launches}")
        stats = json.loads(out)["Statistics"]
        mapped = [stats[key] for key in ("unique_mapped_reads", "ambiguous_mapped_reads",
                                         "unmapped_reads")]
        if sum(mapped) != N_READS or not mapped[0] or not mapped[1]:
            raise AssertionError(f"k={k} {name}: implausible statistics {stats}")
        outs.append((json.loads(out), mapped))
        by_path[f"k={k} strains dumpalign -g, {name}"] = launches
        parts.append("%s: wall %.3f s (fasta %.3f s, host build %.3f s, stream %.3f s "
                     "= %.0f reads/s aligned), peak device memory %d B, launches %s, "
                     "%s" % (name, wall, st.get("fasta_parse", 0.0), st["db_build"],
                             st["stream_align"], N_READS / st["stream_align"], peak,
                             launches, stats))
    # the gate counts each window below it, and filtering them moves reads
    want = low_quality_windows(qual, K_WORDS, WORD_MKQ)
    got = outs[1][0]["Statistics"]["filtered_quality_kmers"]
    if got != want or not 0 < want < qual.shape[0] * (READ_LEN - K_WORDS + 1):
        raise AssertionError(f"k={k}: the MKQ gate filtered {got} windows, numpy {want}")
    if outs[1][1] == outs[0][1]:
        raise AssertionError(f"k={k}: the MKQ gate moved no read: {outs[1][1]}")
    parts.append(f"MKQ {WORD_MKQ} filtered {got} of "
                 f"{qual.shape[0] * (READ_LEN - K_WORDS + 1)} windows (numpy: {want})")

    kdb, aln = os.path.join(tmp, "s75.kdb"), os.path.join(tmp, "s75.aln")
    _, ref_st, _, ref_wall, _ = counted_run(
        ["-t", "reference", "-g", fa, "-k", k, "-r", kdb], stream=False)
    _, st, launches, wall, peak = counted_run(["-t", "align", "-r", kdb, "--reads", fq,
                                               "-a", aln])
    by_path[f"k={k} strains align -r"] = launches
    direct, dst, _, _, _ = counted_run(["-t", "dumpalign", "-r", kdb, "--reads", fq])
    if run_cli(["-t", "dumpalign", "-a", aln]) != direct:
        raise AssertionError(f"k={k}: dumpalign -a != dumpalign -r --reads")
    if json.loads(direct) != outs[0][0]:
        raise AssertionError(f"k={k}: dumpalign -r != dumpalign -g")
    parts.append("reference: host build %.3f s, .kdb write %.3f s, wall %.3f s, .kdb %d "
                 "B; align -r: stream %.3f s = %.0f reads/s aligned (read store %.3f "
                 "s), .aln write %.3f s, wall %.3f s, peak %d B, launches %s; "
                 "dumpalign -r --reads: stream %.3f s = %.0f reads/s aligned" % (
                     ref_st["db_build"], ref_st["kdb_save"], ref_wall,
                     os.path.getsize(kdb), st["stream_align"],
                     N_READS / st["stream_align"], st["read_store"], st["aln_save"],
                     wall, peak, launches, dst["stream_align"],
                     N_READS / dst["stream_align"]))

    # the first BATCH gated reads on the card and on the CPU (plain versions)
    head = ["-t", "dumpalign", "-r", kdb, "--reads", fq_q_head] + gate
    card = run_cli(head)
    t0 = time.perf_counter()
    cpu = run_cli(head, {"SHOTGUN_TPU_TORCH_DEVICE": "cpu"})
    cpu_s = time.perf_counter() - t0
    head_want = low_quality_windows(qual[:BATCH], K_WORDS, WORD_MKQ)
    head_got = json.loads(card)["Statistics"]["filtered_quality_kmers"]
    if cpu != card or head_got != head_want:
        raise AssertionError(f"k={k}: the first {BATCH} reads differ on the CPU, or "
                             f"filtered {head_got} windows, numpy {head_want}")
    parts.append(f"the first {BATCH} reads with MKQ {WORD_MKQ}: the card's summary == the "
                 f"CPU's (plain versions, {cpu_s:.3f} s), {head_got} windows filtered")
    os.remove(kdb)
    os.remove(aln)
    say("phase 9 multi-word keys, k=%s on the strain panel (%d reads): host build + "
        "word sort join, H1 launched and H2 not, statistics plausible, the MKQ gate's "
        "count == numpy's and its reads moved, dumpalign -a == -r --reads == -g; %s" % (
            k, N_READS, "; ".join(parts)))
    return by_path


def phase_packed() -> dict:
    """Phase 10: ``align_packed_reads`` against ``align_stream`` on the
    golden corpus, on the sort join, the 4-slot hash (H2) and k = 35;
    returns each packed run's kernel launches."""
    from shotgun_tpu_torch.aligner import PseudoAlignment, ReadMappingType
    from shotgun_tpu_torch.io.data_file import FASTAFile, FASTAQFile, open_fastq_stream
    from shotgun_tpu_torch.io.packing import pack_reads
    from shotgun_tpu_torch.ops.encode import encode_window
    from shotgun_tpu_torch.ops.probe import hash_probe
    from shotgun_tpu_torch.reference import PROBE_ENV, KmerReference

    data = os.path.join(GOLDEN, "data")
    fa, fq = os.path.join(data, "corpus.fa"), os.path.join(data, "corpus.fq")
    batch = pack_reads(list(FASTAQFile(fq).container))
    genomes = FASTAFile(fa).container
    by_path = {}
    for route, k, hashed in (("sort", 11, False), ("hash", 11, True), ("sort", 35, False)):
        os.environ[PROBE_ENV] = route
        try:
            ref = KmerReference(k, genomes)
            runs = []
            for packed in (False, True):
                aln = PseudoAlignment(ref)
                encode_window.launches = hash_probe.launches = 0
                if packed:
                    aln.align_packed_reads(batch, batch_size=16)
                else:
                    aln.align_stream(open_fastq_stream(fq), batch_size=16, store_reads=True)
                # JSON text: the Summary's order counts
                runs.append((json.dumps(aln.get_summary()),
                             [aln.get_reads_by_mapping_type(t) for t in ReadMappingType]))
        finally:
            os.environ.pop(PROBE_ENV)
        name = f"k={k} {route}"
        launches = {"encode_window": encode_window.launches,
                    "hash_probe": hash_probe.launches}
        if runs[0] != runs[1]:
            raise AssertionError(f"align_packed_reads ({name}) != align_stream")
        if k == 11 and runs[1][0] != json.dumps(json.loads(golden("plain"))):
            raise AssertionError(f"align_packed_reads ({name}): not the plain case")
        if launches["encode_window"] <= 0 or (launches["hash_probe"] > 0) != hashed:
            raise AssertionError(f"align_packed_reads ({name}): launches {launches}")
        by_path[f"align_packed_reads, {name}"] = launches
    say("phase 10 align_packed_reads == align_stream (summary and read store) on the "
        "golden corpus, %d reads: %s" % (batch.num_reads, "; ".join(
            f"{p}: launches {n}" for p, n in by_path.items())))
    return by_path


#: the child of phases 11d and 12b: the port's CLI, then its kernel
#: launches on stderr
CLI_CHILD = r"""
import json, sys
from shotgun_tpu_torch.cli import main
from shotgun_tpu_torch.ops.encode import encode_window
from shotgun_tpu_torch.ops.probe import hash_probe
try:
    main(sys.argv[1:])
finally:
    print("launches " + json.dumps({"encode_window": encode_window.launches,
                                    "hash_probe": hash_probe.launches}), file=sys.stderr)
"""


def mesh_run(ref, batch, mesh, device, mkq=None) -> tuple:
    """``align_packed_reads`` of ``batch`` over ``mesh`` (None: one device)
    with the CLI's auto batch size, every kernel's count set to 0 just
    before it: (the summary as the CLI prints it, launches, wall s)."""
    import torch

    from shotgun_tpu_torch.aligner import PseudoAlignment

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    aln = PseudoAlignment(ref, device)
    aln.align_packed_reads(batch, min_kmer_quality=mkq, batch_size=0, store_reads=False,
                           mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    return json.dumps(aln.get_summary(), indent=4) + "\n", launches, wall


def batch_ms(fn, iters: int = 5) -> float:
    """ms a call of ``fn`` on the card's clock: CUDA events around
    ``iters`` back-to-back calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def tp_batch_ms(ref, batch, device) -> tuple:
    """One batch of BATCH reads (no gate) on the sort table: ms a batch on
    one device and on the 2 x 2 DP x TP mesh of cuda:0."""
    import torch

    from shotgun_tpu_torch.models.pipeline import aggregate_batch, align_batch
    from shotgun_tpu_torch.ops.encode import pack_codes_2bit
    from shotgun_tpu_torch.parallel.mesh import replicate, shard_read_arrays
    from shotgun_tpu_torch.parallel.table_sharded import (
        align_aggregate_table_sharded,
        device_put_sharded_table,
        make_mesh_2d,
        shard_sorted_table,
    )

    codes = np.zeros((BATCH, LPAD), dtype=np.uint8)
    codes[:, : batch.max_len] = batch.codes[:BATCH]
    arrays = (pack_codes_2bit(codes), None, batch.lengths[:BATCH].astype(np.int32),
              np.ones(BATCH, dtype=bool))
    flags = dict(k=K, has_mrq=False, has_mkq=False, has_mg=False)
    tab, member = ref.device_probe_tables(device), ref.set_member_device(device)
    one_args = [None if a is None else torch.from_numpy(a).to(device) for a in arrays]
    one = batch_ms(lambda: aggregate_batch(align_batch(
        tab, member, *one_args[:3], 1, 1, 0, 0, 0, **flags), one_args[3]))
    mesh = make_mesh_2d([device] * 4, data=2, table=2)
    parts = device_put_sharded_table(mesh, shard_sorted_table(tab, 2))
    (members,) = replicate(mesh, member)
    shards = shard_read_arrays(mesh, *arrays)
    tp = batch_ms(lambda: align_aggregate_table_sharded(
        parts, members, *shards, 1, 1, 0, 0, 0, mesh=mesh, **flags))
    return one, tp


def two_process_cli(argv, strain_out: str) -> tuple:
    """Phase 11d: two CLI processes on cuda:0 (``SHOTGUN_TPU_NPROCS=2``);
    (wall s, backend, process 0's stages, each process's launches)."""
    from shotgun_tpu_torch.tools.dryrun import run_two_processes

    t0 = time.perf_counter()
    outs = run_two_processes(["-c", CLI_CHILD, *argv, "--profile"],
                             dict(os.environ, SHOTGUN_TPU_TORCH_DEVICE="cuda"), timeout=400)
    wall = time.perf_counter() - t0
    if not outs[0][0].endswith(strain_out):
        raise AssertionError("11d: process 0's summary != phase 6's")
    if "{" in outs[1][0]:
        raise AssertionError("11d: process 1 printed a summary")
    backend = outs[0][1].split("backend ", 1)[1].split()[0]
    launches = [child_launches(err) for _, err in outs]
    return wall, backend, profile_stages(outs[0][1]), launches


def profile_stages(stderr: str) -> dict:
    """{stage: seconds} of a CLI run's ``--profile`` report on stderr."""
    stages = {}
    for line in stderr.split("=== profile ===", 1)[1].splitlines():
        fields = line.split()
        if len(fields) >= 3 and fields[2] == "ms":
            stages[fields[0]] = float(fields[1]) / 1e3
    return stages


def child_launches(stderr: str) -> dict:
    """The kernel launches CLI_CHILD reports on stderr."""
    return json.loads(stderr.rsplit("launches ", 1)[1].splitlines()[0])


def phase_mesh(fa: str, fq: str, sfa: str, sfq: str, main_out: str, main_peak: int,
               strain_out: str, device) -> dict:
    """Phase 11: the multi-device paths on cuda:0 against the single-device
    summaries of phases 5 and 6; returns each path's kernel launches."""
    import torch

    from shotgun_tpu_torch.io.data_file import FASTAFile, FASTAQFile
    from shotgun_tpu_torch.parallel.mesh import make_mesh
    from shotgun_tpu_torch.parallel.table_sharded import make_mesh_2d
    from shotgun_tpu_torch.reference import PROBE_ENV, KmerReference
    from shotgun_tpu_torch.tools.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    by_path, parts = {}, []

    def check(name, out, want, launches, hashed):
        if out != want:
            raise AssertionError(f"11 {name}: the summary differs from its single-device run")
        if launches["encode_window"] <= 0 or (launches["hash_probe"] > 0) != hashed:
            raise AssertionError(f"11 {name}: launches {launches}")
        by_path[f"11 {name}"] = launches

    # 11a: 4 data shards, 32 Mbp, the device build's 16-slot table
    t0 = time.perf_counter()
    batch = FASTAQFile(fq).container.to_read_batch()
    parse_s = time.perf_counter() - t0
    n = batch.num_reads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    main_ref = KmerReference.from_device_build(FASTAFile(fa).container.to_genome_arrays(),
                                               K, device)
    if main_ref.probe_method() != "hash16":
        raise AssertionError(f"11a: the route is {main_ref.probe_method()}, not hash16")
    out, launches, wall = mesh_run(main_ref, batch, make_mesh([device] * 4), device, MKQ)
    peak = torch.cuda.max_memory_allocated()
    check("a: DP 4 shards, 32 Mbp hash16", out, main_out, launches, True)
    parts.append("a. DP, 4 shards, 32 Mbp, 16-slot table (device build), MKQ %d: %d reads "
                 "(FASTQ parsed whole in %.3f s), align_packed_reads %.3f s = %.0f reads/s, "
                 "launches %s, peak device memory %d B (device build + table + align; phase "
                 "5: %d B); summary == phase 5's stdout" % (
                     MKQ, n, parse_s, wall, n / wall, launches, peak, main_peak))

    # 11b: 8 data shards, the strain panel, the sort join
    strain_batch = FASTAQFile(sfq).container.to_read_batch()
    torch.cuda.reset_peak_memory_stats()
    strain_ref = KmerReference.from_device_build(
        FASTAFile(sfa).container.to_genome_arrays(), K, device)
    out, launches, wall = mesh_run(strain_ref, strain_batch, make_mesh([device] * 8), device)
    check("b: DP 8 shards, strains sort", out, strain_out, launches, False)
    parts.append("b. DP, 8 shards, strain panel, sort join (device build): align_packed_reads "
                 "%.3f s = %.0f reads/s, launches %s, peak %d B; summary == phase 6's stdout"
                 % (wall, N_READS / wall, launches, torch.cuda.max_memory_allocated()))

    # 11c: DP x TP, 2 x 2, the sorted table in 2 key ranges
    mesh2 = make_mesh_2d([device] * 4, data=2, table=2)
    out, launches, wall = mesh_run(strain_ref, strain_batch, mesh2, device)
    check("c: DP x TP 2x2, strains", out, strain_out, launches, False)
    one_ms, tp_ms = tp_batch_ms(strain_ref, strain_batch, device)
    parts.append("c. DP x TP 2 x 2, strain panel (%d table rows in 2 key ranges): %.3f s = "
                 "%.0f reads/s, launches %s; a batch of %d reads %.3f ms against %.3f ms on "
                 "one device (sort join); summary == phase 6's" % (
                     strain_ref.index.num_kmers, wall, N_READS / wall, launches, BATCH,
                     tp_ms, one_ms))
    del strain_ref
    os.environ[PROBE_ENV] = "sort"
    try:
        torch.cuda.reset_peak_memory_stats()
        one_out, one_launches, one_wall = mesh_run(main_ref, batch, None, device, MKQ)
        check("c: one device, 32 Mbp sort", one_out, main_out, one_launches, False)
        one_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, launches, wall = mesh_run(main_ref, batch, mesh2, device, MKQ)
        check("c: DP x TP 2x2, 32 Mbp sort", out, one_out, launches, False)
        tp_peak = torch.cuda.max_memory_allocated()
        rows = main_ref.device_probe_tables(device).sid.numel()
        one_ms, tp_ms = tp_batch_ms(main_ref, batch, device)
    finally:
        os.environ.pop(PROBE_ENV)
    parts.append("c. DP x TP 2 x 2, 32 Mbp sort table (%d rows in 2 key ranges): %.3f s = "
                 "%.0f reads/s, launches %s, peak %d B; one device, sort join: %.3f s = "
                 "%.0f reads/s, peak %d B; a batch of %d reads %.3f ms against %.3f ms on "
                 "one device; both summaries == phase 5's" % (
                     rows, wall, n / wall, launches, tp_peak, one_wall, n / one_wall,
                     one_peak, BATCH, tp_ms, one_ms))
    del main_ref, batch, strain_batch
    torch.cuda.empty_cache()

    # 11d: two CLI processes on cuda:0, over gloo
    wall, backend, stages, launches = two_process_cli(
        ["-t", "dumpalign", "-g", sfa, "-k", str(K), "--reads", sfq], strain_out)
    if backend != "gloo":
        raise AssertionError(f"11d: backend {backend}, not gloo (one card, two processes)")
    for rank, got in enumerate(launches):
        if got["encode_window"] <= 0 or got["hash_probe"] != 0:
            raise AssertionError(f"11d: process {rank} launches {got}")
        by_path[f"11 d: 2-process CLI, process {rank}"] = got
    parts.append("d. 2-process CLI dumpalign -g on the strain panel, both on cuda:0, backend "
                 "%s: wall %.3f s (process 0: host build %.3f s, FASTQ parse %.3f s, align "
                 "%.3f s = %.0f reads/s), launches %s; process 0 == phase 6, process 1 "
                 "silent" % (backend, wall, stages.get("db_build", 0.0),
                             stages.get("fastq_parse", 0.0), stages.get("align", 0.0),
                             N_READS / stages["align"], launches))

    # 11e: the dry run of tools/dryrun.py
    t0 = time.perf_counter()
    dryrun_multichip(4, device)
    parts.append("e. dryrun_multichip(4) on cuda:0 passed in %.3f s" % (
        time.perf_counter() - t0))
    say("phase 11 multi-device paths on one card (%.3f s): %s" % (
        time.perf_counter() - t_phase, "; ".join(parts)))
    return by_path


def host_memory() -> str:
    """The host's RAM, total and available, from /proc/meminfo."""
    with open("/proc/meminfo") as fh:
        info = dict(line.split(":", 1) for line in fh)
    return "host RAM %d B, %d B available" % tuple(
        int(info[name].split()[0]) * 1024 for name in ("MemTotal", "MemAvailable"))


def peak_rss() -> int:
    """Peak resident bytes of this process (``getrusage``'s ru_maxrss)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def rss_bytes(pid: int):
    """Resident bytes of process ``pid`` (``/proc/<pid>/statm``), None where
    the host's ``/proc`` gives none."""
    try:
        with open(f"/proc/{pid}/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


def run_watching_rss(cmd: list, timeout: float, **kw) -> tuple:
    """``cmd`` run to its end, its resident memory sampled from this
    process every 0.1 s (a child's own ``getrusage`` peak starts from its
    parent's across fork + exec): (CompletedProcess with text stdout and
    stderr, the largest sample in bytes or None)."""
    with tempfile.TemporaryFile("w+") as out, tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, text=True, **kw)
        peak, deadline = None, time.monotonic() + timeout
        try:
            while proc.poll() is None:
                if time.monotonic() > deadline:
                    raise subprocess.TimeoutExpired(cmd, timeout)
                rss = rss_bytes(proc.pid)
                if rss is not None:
                    peak = max(peak or 0, rss)
                time.sleep(0.1)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        err.seek(0)
        return subprocess.CompletedProcess(cmd, proc.returncode, out.read(), err.read()), peak


def phase_100mbp_devbuild(tmp: str, device) -> tuple:
    """Phase 12a: ``devbuild_proof`` at its defaults (the sort join under
    the default budget), the same genomes built again with the budget at
    P12_BUDGET (the 2^25-bucket 16-slot table, H2), equal summaries; each
    route's profile; H1 on the genome row and H2 on that table against
    their plain versions.  Returns ({path: launches}, H1 mode, H2 mode)."""
    import torch

    from shotgun_tpu_torch.index.device_build import HBM_BUDGET_ENV, _host_prep
    from shotgun_tpu_torch.ops.encode import encode_window, encode_window_plain, pack_codes_2bit
    from shotgun_tpu_torch.ops.probe import hash_probe, hash_probe_plain
    from shotgun_tpu_torch.reference import KmerReference
    from shotgun_tpu_torch.tools import devbuild_proof
    from shotgun_tpu_torch.tools.bench_encode import bound_ms, h1_bytes
    from shotgun_tpu_torch.tools.bench_probe import h2_bytes
    from shotgun_tpu_torch.tools.profile_align import profile_route
    from shotgun_tpu_torch.utils.synth import write_fastq

    def log(msg):
        say("  12a " + msg)

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = devbuild_proof.run(device=device, log=log)
    by_path = {"12a devbuild_proof (sort join, default budget)": read_launches()}
    sort_peak = torch.cuda.max_memory_allocated()
    if res["num_kmers"] < P12_MIN_KEYS:
        raise AssertionError(f"12a: {res['num_kmers']} distinct 31-mers < {P12_MIN_KEYS}")
    genomes, reads, ref = res["genomes"], res["reads"], res["ref"]
    parts = ["devbuild_proof: %d distinct 31-mers, device build cold %.3f s, warm %.3f s; "
             "auto table under the default budget: %s (%s, %d B); align %.3f s = %.0f "
             "reads/s; cross-check passed; launches %s; peak device memory %d B" % (
                 res["num_kmers"], res["build_cold_s"], res["build_warm_s"],
                 res["table"]["type"], res["table"]["method"], res["table"]["bytes"],
                 res["align"]["seconds"], res["align"]["reads_per_s"],
                 by_path["12a devbuild_proof (sort join, default budget)"], sort_peak)]

    # the same genomes with the budget raised before the first table call:
    # build, assembly and align counted from 0, as phase 5 counts its path
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    encode_window.launches_by_mode.clear()
    hash_probe.launches_by_mode.clear()
    saved = os.environ.get(HBM_BUDGET_ENV)
    os.environ[HBM_BUDGET_ENV] = str(P12_BUDGET)
    try:
        ref16 = KmerReference.from_device_build(genomes, K, device)
        table = devbuild_proof.probe_table(ref16, device, log)
    finally:
        os.environ.pop(HBM_BUDGET_ENV)
        if saved is not None:
            os.environ[HBM_BUDGET_ENV] = saved
    if table["method"] != "hash16" or table["shape"][:2] != [P12_BUCKETS, 16]:
        raise AssertionError(f"12a: budget {P12_BUDGET}: table {table}")
    al16 = devbuild_proof.align(ref16, reads, device, P12_BATCH, log)
    launches16 = read_launches()
    by_path["12a hash16 (budget raised)"] = launches16
    row_launches = encode_window.launches_by_mode["keys, one row"]
    table_launches = hash_probe.launches_by_mode["16-slot"]
    if row_launches != 1 or table_launches <= 0 or launches16["encode_window"] <= 1:
        raise AssertionError(f"12a hash16: launches {launches16}, by mode "
                             f"{dict(encode_window.launches_by_mode)}")
    if al16["summary"] != res["align"]["summary"]:
        raise AssertionError("12a: the sort and hash16 summaries differ")
    parts.append("budget %d: hash16 table %s (%d B) assembled in %.3f s, align %.3f s = "
                 "%.0f reads/s, launches %s, peak device memory %d B; summary == sort's" % (
                     P12_BUDGET, table["shape"], table["bytes"], table["seconds"],
                     al16["seconds"], al16["reads_per_s"], launches16,
                     torch.cuda.max_memory_allocated()))
    fq = os.path.join(tmp, "devbuild.fq")
    write_fastq(fq, reads.codes)
    for name, r in (("sort", ref), ("hash16", ref16)):
        prof = profile_route(r, fq, device, P12_BATCH)
        parts.append("%s route, the reads streamed from a FASTQ: %.0f reads/s, device "
                     "pipeline alone %.3f ms a batch of %d, profiled stream %.3f ms with the "
                     "device busy %.3f ms: idle share %.4f" % (
                         name, prof["stream_reads_per_s"], prof["device_ms_per_batch"],
                         P12_BATCH, prof["wall_ms"], prof["busy_ms"], prof["idle_share"]))
    os.remove(fq)

    # H1 on the 100 Mbp genome row, H2 on the 2^25-bucket table
    row_d = torch.from_numpy(_host_prep(genomes)[0]).to(device)[None]
    err_row = max_abs_err([encode_window(row_d, K)[0]], [encode_window_plain(row_d, K)[0]])
    w = row_d.shape[1] * 4 - K + 1
    row_ms, row_plain_ms = timed(lambda: encode_window(row_d, K),
                                 lambda: encode_window_plain(row_d, K), w * 8, 20, 3)
    row_bytes = h1_bytes(1, row_d.shape[1], K, True, False)
    del row_d
    tab16 = ref16.device_probe_tables(device)
    padded = np.zeros((P12_BATCH, LPAD), dtype=np.uint8)
    padded[:, :READ_LEN] = reads.codes[:P12_BATCH]
    keys, _ = encode_window(torch.from_numpy(pack_codes_2bit(padded)).to(device), K)
    args = (tab16.table, tab16.stash, keys)
    err_probe = max_abs_err(hash_probe(*args), hash_probe_plain(*args))
    h2_nbytes, buckets = h2_bytes(*args)
    probe_ms, probe_plain_ms = timed(lambda: hash_probe(*args),
                                     lambda: hash_probe_plain(*args), keys.numel() * 12, 100)
    if max(err_row, err_probe) != 0:
        raise AssertionError(f"12a kernel != plain: H1 row {err_row}, H2 {err_probe}")
    h1_mode = {"shape": f"[1, {genomes.codes.size}] (100 Mbp genome as one row)",
               "mode": "keys, one row, 100 Mbp", "bytes": row_bytes,
               "bound_ms": bound_ms(row_bytes), "bound_share": bound_ms(row_bytes) / row_ms,
               "ms": row_ms, "plain_ms": row_plain_ms, "library_ms": None,
               "max_abs_err": err_row, "launches_100mbp": row_launches}
    h2_mode = {"shape": f"{keys.numel()} probes into {tuple(tab16.table.shape)}",
               "mode": "16-slot, 2^25 buckets, 100 Mbp", "bytes": h2_nbytes,
               "bound_ms": bound_ms(h2_nbytes), "bound_share": bound_ms(h2_nbytes) / probe_ms,
               "ms": probe_ms, "plain_ms": probe_plain_ms, "library_ms": None,
               "max_abs_err": err_probe, "distinct_buckets": buckets,
               "stash_rows": tab16.stash.shape[0], "launches_100mbp": table_launches}
    parts += ["H1 %s == plain: %.4f ms vs plain %.4f ms, %d B, bound %.4f ms, %.1f%% of it" % (
                  h1_mode["shape"], row_ms, row_plain_ms, row_bytes, h1_mode["bound_ms"],
                  100 * h1_mode["bound_share"]),
              "H2 %s == plain (stash %d rows): %.4f ms vs plain %.4f ms, %d B (%d distinct "
              "rows), bound %.4f ms, %.1f%% of it" % (
                  h2_mode["shape"], h2_mode["stash_rows"], probe_ms, probe_plain_ms,
                  h2_nbytes, buckets, h2_mode["bound_ms"], 100 * h2_mode["bound_share"])]
    say("phase 12a 100 Mbp device build (%.3f s): %s; host peak RSS %d B" % (
        time.perf_counter() - t_phase, "; ".join(parts), peak_rss()))
    return by_path, h1_mode, h2_mode


def phase_100mbp_bulk(tmp: str, device) -> dict:
    """Phase 12b: ``bulk_proof`` part a (host build, the host 16-slot
    table, the stream twice, 64 sampled reads), the reference saved as a
    ``.kdb`` and ``-t dumpalign -r`` of it on the FASTQ in a CLI child,
    whose stdout must be the library's summary.  Returns {path: launches}."""
    import gc

    import torch

    from shotgun_tpu_torch.tools import bulk_proof

    def log(msg):
        say("  12b " + msg)

    free = shutil.disk_usage(tmp).free
    say("phase 12b: %s; %d B free in %s" % (host_memory(), free, tmp))
    if free < P12_DISK:
        raise AssertionError(f"12b needs {P12_DISK} B free in {tmp} for the FASTQ and "
                             f"the .kdb, has {free}")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    a = bulk_proof.part_a(tmp, device, log=log)
    by_path = {"12b bulk_proof part a (host hash16)": read_launches()}
    lib_peak = torch.cuda.max_memory_allocated()
    if a["num_kmers"] < P12_MIN_KEYS or a["table"]["method"] != "hash16":
        raise AssertionError(f"12b: {a['num_kmers']} k-mers, route {a['table']['method']}")
    if min(by_path["12b bulk_proof part a (host hash16)"].values()) <= 0:
        raise AssertionError(f"12b: launches {by_path}")
    lib_wall = time.perf_counter() - t_phase
    kdb = os.path.join(tmp, "bulk.kdb")
    t0 = time.perf_counter()
    a["ref"].save(kdb)
    save_s, kdb_bytes = time.perf_counter() - t0, os.path.getsize(kdb)
    want = json.dumps(a["summary"], indent=4) + "\n"
    del a["ref"]
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    proc, child_rss = run_watching_rss(
        [sys.executable, "-c", CLI_CHILD, "-t", "dumpalign", "-r", kdb, "--reads",
         a["fastq"], "--profile"], 900, cwd=HERE,
        env=dict(os.environ, SHOTGUN_TPU_TORCH_DEVICE="cuda"))
    cli_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"12b CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
    if proc.stdout != want:
        raise AssertionError("12b: the CLI's dumpalign -r stdout != the library summary")
    stages = profile_stages(proc.stderr)
    by_path["12b CLI dumpalign -r .kdb"] = cli = child_launches(proc.stderr)
    if cli["encode_window"] <= 0 or cli["hash_probe"] <= 0:
        raise AssertionError(f"12b CLI: launches {cli}")
    os.remove(kdb)
    os.remove(a["fastq"])
    n = a["reads"]
    say("phase 12b 100 Mbp host build (%.3f s): %d distinct 31-mers, %d sets; library: "
        "host build %.3f s, sort table prep + upload %.3f s (%d B), FASTQ %.3f s (%d B), "
        "host 16-slot table %.3f s (%d B), stream warm %.3f s, timed %.3f s = %.0f reads/s, "
        "%d/%d sampled reads == Read.pseudo_align (%.3f s), wall %.3f s, peak device "
        "memory %d B, launches %s; .kdb %d B written in %.3f s; CLI dumpalign -r .kdb "
        "--reads (a child): stdout == the library summary, wall %.3f s, kdb_load %.3f s, "
        "table_build %.3f s, stream_align %.3f s = %.0f reads/s, launches %s, peak RSS %s "
        "(sampled from outside every 0.1 s); host peak RSS %d B; %s" % (
            time.perf_counter() - t_phase, a["num_kmers"], a["num_sets"], a["host_build_s"],
            a["sort_table"]["seconds"], a["sort_table"]["bytes"], a["fastq_s"],
            a["fastq_bytes"], a["table"]["seconds"], a["table"]["bytes"],
            a["stream_warm_s"], a["stream_timed_s"], n / a["stream_timed_s"],
            a["sampled"] - a["mismatches"], a["sampled"], a["sample_s"], lib_wall, lib_peak,
            by_path["12b bulk_proof part a (host hash16)"], kdb_bytes, save_s, cli_wall,
            stages["kdb_load"], stages["table_build"], stages["stream_align"],
            n / stages["stream_align"], cli,
            "not measured" if child_rss is None else f"{child_rss} B", peak_rss(),
            host_memory()))
    return by_path


def phase_100mbp_words(device) -> dict:
    """Phase 12c: ``bulk_proof`` part b (k = 75, the sharded probe on a
    1 x 1 mesh equal to the unsharded one).  Returns {path: launches}."""
    import torch

    from shotgun_tpu_torch.tools import bulk_proof

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    b = bulk_proof.part_b(device, log=lambda msg: say("  12c " + msg))
    launches = read_launches()
    if launches["encode_window"] <= 0 or launches["hash_probe"] != 0:
        raise AssertionError(f"12c: launches {launches}")
    say("phase 12c k=75 at %d keys (%.3f s): host build %.3f s, sharded table %d B "
        "uploaded in %.3f s, sharded probe %.3f s; sharded == unsharded in every field; "
        "launches %s, peak device memory %d B; host peak RSS %d B" % (
            b["num_kmers"], time.perf_counter() - t0, b["host_build_s"],
            b["sharded_table"]["bytes"], b["sharded_table"]["seconds"], b["sharded_s"],
            launches, torch.cuda.max_memory_allocated(), peak_rss()))
    return {"12c bulk_proof part b (k=75, 1 x 1 mesh)": launches}


#: phase 13: each tool child's time limit, s
P13_TIMEOUT = 600
#: phase 13: the bench's probes of a read (150 - 31 + 1 windows)
P13_WINDOWS = READ_LEN - K + 1


def run_tool(module: str, *args: str) -> tuple:
    """``python -m shotgun_tpu_torch.tools.<module> args`` in a child on
    the card: (its last stdout line as JSON, wall s).  A non-zero exit,
    or a last line that is not JSON, raises."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", f"shotgun_tpu_torch.tools.{module}", *args],
        capture_output=True, text=True, timeout=P13_TIMEOUT, cwd=HERE,
        env=dict(os.environ, SHOTGUN_TPU_TORCH_DEVICE="cuda"))
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"13: {module} {' '.join(args)} exited {out.returncode}: "
                             f"{out.stdout[-2000:]}{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1]), wall


def check_bench(head: dict, probe: str) -> dict:
    """Phase 13's checks of one bench headline: the stream's statistics add
    up to the reads, the staged totals and the align task's summary equal
    the stream's, the rates are positive, the kernels ran, and the route's
    staged batches launched H1 (and H2 on a hash table).  The staged
    launches."""
    extra = head["extra"]
    if head["metric"] != "pseudo_align_reads_per_sec_k31" or "error" in extra:
        raise AssertionError(f"13: bench {probe}: {head}")
    stats = extra["stream_statistics"]
    if sum(stats.values()) != N_READS:
        raise AssertionError(f"13: bench {probe}: statistics {stats} != {N_READS} reads")
    want = {"unique": stats["unique_mapped_reads"],
            "ambiguous": stats["ambiguous_mapped_reads"], "unmapped": stats["unmapped_reads"]}
    if extra["staged_totals"] != want or extra["align_task_summary_equal"] is not True:
        raise AssertionError(f"13: bench {probe}: staged {extra['staged_totals']}, "
                             f"stream {want}, align task {extra['align_task_summary_equal']}")
    rates = (head["value"], extra["end_to_end_reads_per_sec"], extra["kmer_probes_per_sec"])
    if not min(rates) > 0 or extra["kmer_probes_per_sec"] != head["value"] * P13_WINDOWS:
        raise AssertionError(f"13: bench {probe}: rates {rates}")
    if not isinstance(extra["kernels"], dict) or not isinstance(extra["cold_start"], dict):
        raise AssertionError(f"13: bench {probe}: kernels {extra['kernels']}, "
                             f"cold start {extra['cold_start']}")
    launches = extra["kernel_launches"]["staged"]
    batches = extra["staged_batches"]
    if launches != {"encode_window": batches,
                    "hash_probe": batches if probe != "sort" else 0}:
        raise AssertionError(f"13: bench {probe}: staged launches {launches}")
    return launches


def say_bench(label: str, head: dict, wall: float) -> None:
    extra = head["extra"]
    kern = extra["kernels"]
    say(f"phase {label} ({wall:.3f} s, {extra['device']}): staged {head['value']:.1f} "
        f"reads/s ({extra['probe_table']['type']}), {extra['kmer_probes_per_sec']:.1f} "
        f"probes/s, first batch {extra['first_batch_s']:.4f} s; stream median "
        f"{extra['end_to_end_reads_per_sec']:.1f} reads/s (passes "
        f"{extra['e2e_pass_times_s']}); align task {extra['align_task_reads_per_sec']:.1f} "
        f"reads/s, dumpalign -a {extra['dumpalign_a_s']:.4f} s; host build "
        f"{extra['db_build_mbp_per_sec']:.3f} Mbp/s, device build "
        f"{extra['db_build_device_mbp_per_sec']:.3f} Mbp/s; H1 "
        f"{kern['encode_window']['ms']:.4f} ms ({kern['encode_window']['bound_share']:.3f} "
        f"of its bound), H2 {kern['hash_probe']['ms']:.4f} ms "
        f"({kern['hash_probe']['bound_share']:.3f}); stages ms {extra['stage_profile_ms']}, "
        f"device ms {extra['stage_profile_device_ms']}")
    say(json.dumps(head))


def phase_bench() -> dict:
    """Phase 13: the port's benchmark at its defaults (the BASELINE
    workload on the sort join) and on the 16-slot table without the
    32 Mbp builds, then the stage profiler on the sort and hash16 routes
    and the device-build profiler at 1 and 32 Mbp, each in a child on the
    card.  Returns {path: launches} of the bench's staged batches."""
    t13 = time.perf_counter()
    by_path = {}
    for label, probe, args in (("13a bench", "sort", ()),
                               ("13b bench", "hash16", ("--probe", "hash16",
                                                        "--devbuild-mbp", "0"))):
        head, wall = run_tool("bench", *args)
        by_path[f"{label} {probe} staged"] = check_bench(head, probe)
        say_bench(f"{label} {probe}", head, wall)
    for probe in ("sort", "hash16"):
        res, wall = run_tool("profile_stages", "--probe", probe)
        say(f"phase 13c profile_stages {probe} ({wall:.3f} s): fused {res['fused_ms']:.4f} "
            f"ms a batch of {res['batch'][0]}, sum of stages {res['sum_ms']:.4f} ms, "
            f"{res['reads_per_s_at_fused']:.1f} reads/s at fused (device ms); ms {res['ms']}, "
            f"device ms {res['device_ms']}")
    res, wall = run_tool("profile_devbuild", "1", "32")
    for size in res["sizes"]:
        say(f"phase 13d profile_devbuild {size['mbp']:g} Mbp ({wall:.3f} s in all): host "
            f"prep {size['host_prep_s']:.4f} s, " + "; ".join(
                f"upload {it['upload_s']:.4f} compute {it['compute_s']:.4f} fetch "
                f"{it['fetch_s']:.4f} s" for it in size["iters"])
            + f"; from_device_build warm {size['from_device_build_s']:.4f} s "
            f"({size['num_kmers']} k-mers)")
    say(f"phase 13 in {time.perf_counter() - t13:.3f} s")
    return by_path


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
        sample_reads,
        strain_panel,
        strain_reads,
        synth_genomes,
        write_fastq,
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
    strains = strain_panel(rng)
    strain_work = strain_reads(rng, strains, N_READS)
    # phase 9's qualities, from a generator of their own
    strain_qual = np.random.default_rng([args.seed, 9]).integers(
        WORD_QUAL[0], WORD_QUAL[1] + 1, size=strain_work.codes.shape, dtype=np.uint8)

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
        launches, by_mode, main_out, main_peak = phase_main_path(fa, fq, gi)
        torch.cuda.empty_cache()

        # 6. strain panel on four routes
        sfa, sfq = os.path.join(tmp, "s.fa"), os.path.join(tmp, "s.fq")
        sqfq, sqfq_head = os.path.join(tmp, "sq.fq"), os.path.join(tmp, "sq_head.fq")
        write_workload(strain_work, sfa, sfq)
        write_fastq(sqfq, strain_work.codes, strain_qual)
        write_fastq(sqfq_head, strain_work.codes[:BATCH], strain_qual[:BATCH])
        del strains, strain_work
        strain_routes, strain_out = phase_strains(sfa, sfq)
        by_path = {"main path": launches, **strain_routes}
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

        # 9. multi-word keys at size; 10. the library's packed route
        words_by_path = phase_words(tmp, sfa, sfq, sqfq, sqfq_head, strain_qual)
        by_path.update(words_by_path)
        torch.cuda.empty_cache()
        by_path.update(phase_packed())
        torch.cuda.empty_cache()

        # 11. the multi-device paths, several shards on the one card
        by_path.update(phase_mesh(fa, fq, sfa, sfq, main_out, main_peak, strain_out, device))
        torch.cuda.empty_cache()

        # 12. the JAX repo's proven scale: 100 Mbp, about 100M 31-mers
        t12 = time.perf_counter()
        paths12, h1_100mbp, h2_100mbp = phase_100mbp_devbuild(tmp, device)
        by_path.update(paths12)
        torch.cuda.empty_cache()
        by_path.update(phase_100mbp_bulk(tmp, device))
        torch.cuda.empty_cache()
        by_path.update(phase_100mbp_words(device))
        say(f"phase 12 in {time.perf_counter() - t12:.3f} s")
    torch.cuda.empty_cache()

    # 13. the port's benchmark and stage profilers, each in a child
    by_path.update(phase_bench())

    word_launches = words_by_path[
        f"k={K_WORDS} strains dumpalign -g, random quality, MKQ {WORD_MKQ}"]
    kernels[0]["modes"].append(h1_100mbp)
    kernels[1]["modes"].append(h2_100mbp)
    for kr in kernels:
        kr["launches"] = launches[kr["name"]]
        kr["launches_by_path"] = {p: n[kr["name"]] for p, n in by_path.items()}
        for m in kr["modes"]:
            m["launches_main_path"] = by_mode[kr["name"]].get(m["mode"], 0)
            if m["mode"].startswith("words"):
                m["launches_word_path"] = word_launches[kr["name"]]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
