"""Kernel H2 (``hash_probe``) on the card: this checkout's kernel, and
optionally another checkout's, at the two table shapes the hash routes
probe, each held exactly against the plain version and timed beside its
byte bound.

    python -m shotgun_tpu_torch.tools.bench_probe [--other DIR] [--iters N]
        [--seed N]

Shapes (k = 31; one batch of 32,768 150 bp reads on the stream's row
stride of 160 bases, so 4,259,840 probes):

- ``16-slot``: the 16-slot table the device assembles for 32 random 1 Mbp
  genomes (about 32M distinct 31-mers, 2^23 buckets of 256 B), probed with
  error-free reads of them: the main path's ``dumpalign -g``;
- ``4-slot``: the host-built 4-slot table (``SHOTGUN_TPU_PROBE=hash``) of
  the strain panel, 4 copies at 1% mutation of each of 8 random 200 kbp
  ancestors (about 3.3M distinct 31-mers, 2^24 buckets of 64 B), probed
  with its reads at 0.5% substitutions.

Each table's stash is filled to its cap of 64 rows (``plant_stash``), so
every probe compares 64 stash entries, as in ``chip_smoke.py`` phase 4.
``--other DIR`` builds DIR's kernels into ``DIR/build/kernels``; both
builds run in one process, timed in turns (other, this, this, other), so
the two versions are compared on one card.  Timing and bound as in ``bench_encode`` (``device_ms``,
``rotation``, ``bound_ms``); the bytes H2 must move are the keys, one row
per distinct bucket the batch reads, the stash and 12 B of output a probe.
The last line of output is one JSON object.  Needs CUDA; exits 1 without.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from shotgun_tpu_torch.index.build import build_index
from shotgun_tpu_torch.index.device_build import device_build_tables, device_hash_table
from shotgun_tpu_torch.index.hashtable import build_probe_table
from shotgun_tpu_torch.ops.encode import encode_window, mix32, pack_codes_2bit, split_key
from shotgun_tpu_torch.ops.kernels.build import (
    BUILD_DIR,
    CSRC_DIR,
    build,
    check_status,
    declare,
)
from shotgun_tpu_torch.ops.probe import STASH_CAP, hash_probe_plain, hash_table_to_device
from shotgun_tpu_torch.tools.bench_encode import bound_ms, device_ms, rotation
from shotgun_tpu_torch.utils.synth import make_genomes, sample_reads, synth_genomes

K = 31
BATCH = 32768
LPAD = 160
READ_LEN = 150


def plant_stash(real_stash: np.ndarray, hit_keys: np.ndarray,
                miss_keys: np.ndarray, rng) -> np.ndarray:
    """The real stash plus planted rows up to 64: keys the queries hit in
    the table (so stash and table matches merge by min/max/min), repeats
    of them with other values, keys of windows the table misses (so they
    resolve through the stash alone) and keys nothing hits."""
    room = STASH_CAP - real_stash.shape[0]
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


def h2_bytes(table: torch.Tensor, stash: torch.Tensor, keys: torch.Tensor
             ) -> Tuple[int, int]:
    """(bytes H2 must move, distinct buckets read): the int64 keys, one
    row of each distinct bucket the keys hash to, the stash, and three
    int32 outputs a key."""
    lo, hi = split_key(keys.reshape(-1))
    buckets = int(torch.unique(mix32(lo, hi) & (table.shape[0] - 1)).numel())
    n = keys.numel()
    row_bytes = table.shape[1] * table.shape[2] * 4
    return n * 8 + buckets * row_bytes + stash.numel() * 4 + n * 12, buckets


def probe_case(name: str, table: torch.Tensor, real_stash: torch.Tensor,
               codes: np.ndarray, rng) -> dict:
    """One timed shape: the window keys of ``codes`` (reads [B, L] padded
    to the stream's row stride, H1 on the table's device), the stash
    planted to 64 rows, and the bytes and distinct buckets of the probe."""
    b, length = codes.shape
    padded = np.zeros((b, LPAD), dtype=np.uint8)
    padded[:, :length] = codes
    keys, _ = encode_window(torch.from_numpy(pack_codes_2bit(padded)).to(table.device), K)
    keys_np = keys.cpu().numpy()
    # windows past the read end reach into the zero padding: the table
    # misses them, so planting their keys gives stash-only hits
    stash_np = plant_stash(real_stash.cpu().numpy().view(np.uint32),
                           keys_np[:, :length - K + 1], keys_np[:, length - K + 1:], rng)
    stash = torch.from_numpy(stash_np.view(np.int32)).to(table.device)
    nbytes, buckets = h2_bytes(table, stash, keys)
    return dict(name=name, table=table, stash=stash, keys=keys, bytes=nbytes,
                buckets=buckets)


def make_cases(rng: np.random.Generator, device: torch.device, genomes: int = 32,
               genome_len: int = 1_000_000, strains: int = 8, strain_len: int = 200_000,
               batch: int = BATCH) -> List[dict]:
    """The ``16-slot`` and ``4-slot`` shapes of the module doc (smaller
    ones with smaller arguments)."""
    panel = synth_genomes(rng, genomes, genome_len)
    table16, stash16 = device_hash_table(device_build_tables(panel, K, device))
    reads = sample_reads(rng, panel, batch, READ_LEN).codes
    cases = [probe_case("16-slot", table16, stash16, reads, rng)]
    del panel, reads
    strain = make_genomes(rng, genomes, strain_len, strains, 0.01)
    index = build_index(strain, K)
    pt = build_probe_table(index.kmer_lo, index.kmer_hi, index.set_id,
                           index.genome_counts(), slots_per_bucket=4)
    tab4 = hash_table_to_device(pt.table, pt.stash, device)
    reads = sample_reads(rng, strain, batch, READ_LEN, 0.005).codes
    cases.append(probe_case("4-slot", tab4.table, tab4.stash, reads, rng))
    return cases


class H2Library:
    """One build of kernel H2, called through its C entry point."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.lib = declare(ctypes.CDLL(path))

    def __call__(self, table, stash, keys, outs) -> None:
        status = self.lib.stt_hash_probe(
            keys.data_ptr(), table.data_ptr(), table.shape[0], table.shape[1],
            stash.data_ptr() if stash.shape[0] else None, stash.shape[0],
            *(o.data_ptr() for o in outs), keys.numel(), keys.device.index,
            torch.cuda.current_stream(keys.device).cuda_stream)
        check_status(self.lib, status, "hash_probe")


def _time_case(libs: Dict[str, H2Library], order: List[str], case: dict,
               iters: int) -> Dict[str, List[float]]:
    table, stash, keys = case["table"], case["stash"], case["keys"]
    n = rotation(keys.numel() * 12)
    outs = [[torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
             for _ in range(3)] for _ in range(n)]
    want = hash_probe_plain(table, stash, keys)
    times: Dict[str, List[float]] = {name: [] for name in libs}
    for name in order:
        lib = libs[name]
        lib(table, stash, keys, outs[0])
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(outs[0], want)):
            raise AssertionError(f"{name}: H2 {case['name']} != plain")
        times[name].append(device_ms(lambda i: lib(table, stash, keys, outs[i % n]),
                                     iters))
    return times


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout whose H2 is timed beside this one")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_probe: torch.cuda.is_available() is false", file=sys.stderr)
        raise SystemExit(1)
    device = torch.device("cuda", 0)
    jobs = {"this": dict(force=True)}
    if args.other:
        other = os.path.abspath(args.other)
        rel = os.path.relpath(CSRC_DIR, os.path.dirname(os.path.dirname(BUILD_DIR)))
        jobs["other"] = dict(force=True, csrc_dir=os.path.join(other, rel),
                             build_dir=os.path.join(other, "build", "kernels"))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kw: build(**kw), jobs.values())))
    libs = {name: H2Library(b.path) for name, b in built.items()}
    forward = ["other"] * bool(args.other) + ["this"]
    order = forward + forward[::-1]
    for name, b in built.items():  # registers and spills of each build
        print(f"ptxas, {name}:\n{b.log}", file=sys.stderr, flush=True)
    res = {"device": torch.cuda.get_device_name(0), "k": K, "iters": args.iters,
           "order": order, "cases": []}
    for case in make_cases(np.random.default_rng(args.seed), device):
        times = _time_case(libs, order, case, args.iters)
        b = bound_ms(case["bytes"])
        res["cases"].append({
            "name": case["name"], "table": list(case["table"].shape),
            "probes": case["keys"].numel(), "stash": case["stash"].shape[0],
            "distinct_buckets": case["buckets"], "bytes": case["bytes"],
            "bound_ms": b, "ms": times,
            "bound_share": {n: b / min(t) for n, t in times.items()}})
        print(f"{case['name']} {tuple(case['table'].shape)}: {case['bytes']} B, "
              f"bound {b:.4f} ms; " + "; ".join(
                  f"{n} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                  for n, ts in times.items()), flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
