"""Kernel H1 (``encode_window``) on the card: this checkout's kernel, and
optionally another checkout's, at the main path's three shapes, each held
exactly against the plain version and timed beside its byte bound.

    python -m shotgun_tpu_torch.tools.bench_encode [--other DIR] [--iters N]

Shapes (k = 31): a batch of 32,768 reads at row stride 160 (40 packed
bytes a row), keys only (the align routes without ``--min-kmer-quality``)
and keys with quality sums (with it), and the 32 Mbp genome as one row
(the device build).  ``--other DIR`` builds DIR's
``shotgun_tpu_torch/ops/kernels/csrc`` into ``DIR/build/kernels`` and
times it in the same process in turns (other, this, this, other), so two
versions are compared on one card.  Both libraries are called through
their C entry point with the same preallocated outputs.

Timing (``device_ms``): a sleep kernel gives the host a head start, so
all ``iters`` launches are queued before the first runs and the CUDA
events measure the card, not the launch rate; outputs rotate over enough
buffers to pass the 50 MB L2, so every launch writes to memory.  The
bound is the bytes the function must move (each input read once, each
output written once) over 3.35 TB/s, the H100 SXM's HBM rate.  The last
line of output is one JSON object.  Needs CUDA; exits 1 without it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from shotgun_tpu_torch.ops.encode import encode_window_plain
from shotgun_tpu_torch.ops.kernels.build import (
    BUILD_DIR,
    CSRC_DIR,
    LIB_NAME,
    build,
    check_status,
    declare,
)

#: H100 SXM HBM3 bandwidth, bytes/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
#: bytes of output a timing rotation spans at least (past the 50 MB L2)
ROTATE_BYTES = 200 << 20
K = 31
BATCH = 32768
ROW_BYTES = 40
GENOME_BASES = 32_000_000


def h1_bytes(rows: int, packed_width: int, k: int, keys: bool, sums: bool) -> int:
    """Bytes H1 must move for [rows, 4 * packed_width] positions: packed
    codes in and int64 keys out (``keys``), quality bytes in and int32
    sums out (``sums``)."""
    length = 4 * packed_width
    nwin = length - k + 1
    return (rows * (packed_width + 8 * nwin) * keys
            + rows * (length + 4 * nwin) * sums)


def bound_ms(nbytes: int) -> float:
    """Least time to move ``nbytes`` through HBM at 3.35 TB/s, in ms."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def device_ms(fn: Callable[[int], object], iters: int) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls after one
    warm-up call: a sleep kernel holds the card while the host queues
    every call, and CUDA events time the calls back to back.  ``fn``
    should write to a buffer that rotates with ``i``."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's clock
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rotation(out_bytes: int) -> int:
    """Output buffers a timing loop rotates over to pass the L2."""
    return max(2, -(-ROTATE_BYTES // max(out_bytes, 1)))


def kept_ms(fn: Callable[[], object], out_bytes: int, iters: int) -> float:
    """``device_ms`` of ``fn()``, which makes ``out_bytes`` of output a
    call: the outputs are kept alive over a ``rotation``, so every call
    writes to memory that the L2 does not hold."""
    ring = [None] * rotation(out_bytes)

    def call(i: int) -> None:
        ring[i % len(ring)] = fn()

    return device_ms(call, iters)


class H1Library:
    """One build of kernel H1, called through its C entry point."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.lib = declare(ctypes.CDLL(path))

    def __call__(self, packed, qual, keys, qsums, k: int) -> None:
        data = packed if packed is not None else qual
        rows = data.shape[0]
        length = packed.shape[1] * 4 if packed is not None else qual.shape[1]
        ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
        status = self.lib.stt_encode_window(
            ptr(packed), ptr(qual), ptr(keys), ptr(qsums), rows, length, k,
            data.device.index, torch.cuda.current_stream(data.device).cuda_stream)
        check_status(self.lib, status, "encode_window")


def _shapes(rng: np.random.Generator, device: torch.device) -> List[dict]:
    packed = torch.from_numpy(
        rng.integers(0, 256, size=(BATCH, ROW_BYTES), dtype=np.uint8)).to(device)
    qual = torch.from_numpy(
        rng.integers(33, 127, size=(BATCH, 4 * ROW_BYTES), dtype=np.uint8)).to(device)
    row = torch.from_numpy(
        rng.integers(0, 256, size=(1, GENOME_BASES // 4), dtype=np.uint8)).to(device)
    return [
        dict(name="keys", packed=packed, qual=None,
             bytes=h1_bytes(BATCH, ROW_BYTES, K, True, False)),
        dict(name="keys+sums", packed=packed, qual=qual,
             bytes=h1_bytes(BATCH, ROW_BYTES, K, True, True)),
        dict(name="genome row keys", packed=row, qual=None,
             bytes=h1_bytes(1, GENOME_BASES // 4, K, True, False)),
    ]


def _time_shape(libs: Dict[str, H1Library], order: List[str], shape: dict,
                iters: int) -> Dict[str, List[float]]:
    packed, qual = shape["packed"], shape["qual"]
    data = packed if packed is not None else qual
    rows = data.shape[0]
    nwin = (packed.shape[1] * 4 if packed is not None else qual.shape[1]) - K + 1
    out_bytes = rows * nwin * (8 * (packed is not None) + 4 * (qual is not None))
    n = rotation(out_bytes)
    keys = [torch.empty((rows, nwin), dtype=torch.int64, device=data.device)
            if packed is not None else None for _ in range(n)]
    qsums = [torch.empty((rows, nwin), dtype=torch.int32, device=data.device)
             if qual is not None else None for _ in range(n)]
    want = encode_window_plain(packed, K, qual)
    times: Dict[str, List[float]] = {name: [] for name in libs}
    for name in order:
        lib = libs[name]
        lib(packed, qual, keys[0], qsums[0], K)
        torch.cuda.synchronize()
        for got, w in zip((keys[0], qsums[0]), want):
            if w is not None and not torch.equal(got, w):
                raise AssertionError(f"{name}: H1 {shape['name']} != plain")
        times[name].append(device_ms(
            lambda i: lib(packed, qual, keys[i % n], qsums[i % n], K), iters))
    return times


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout whose H1 is timed beside this one")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_encode: torch.cuda.is_available() is false", file=sys.stderr)
        raise SystemExit(1)
    device = torch.device("cuda", 0)
    libs = {"this": H1Library(build(force=True).path)}
    order = ["this", "this"]
    if args.other:
        other = os.path.abspath(args.other)
        rel = os.path.relpath(CSRC_DIR, os.path.dirname(os.path.dirname(BUILD_DIR)))
        libs["other"] = H1Library(build(
            force=True, csrc_dir=os.path.join(other, rel),
            build_dir=os.path.join(other, "build", "kernels")).path)
        assert os.path.basename(libs["other"].path) == LIB_NAME
        order = ["other", "this", "this", "other"]
    res = {"device": torch.cuda.get_device_name(0), "k": K, "iters": args.iters,
           "order": order, "shapes": []}
    for shape in _shapes(np.random.default_rng(args.seed), device):
        times = _time_shape(libs, order, shape, args.iters)
        b = bound_ms(shape["bytes"])
        entry = {"name": shape["name"], "bytes": shape["bytes"], "bound_ms": b,
                 "ms": times, "bound_share": {n: b / min(t) for n, t in times.items()}}
        res["shapes"].append(entry)
        print(f"{shape['name']}: {shape['bytes']} B, bound {b:.4f} ms; " + "; ".join(
            f"{n} " + " / ".join(f"{t:.4f}" for t in ts) + " ms" for n, ts in times.items()),
            flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
