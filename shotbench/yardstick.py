"""The benchmark's frozen arithmetic: device busy time from a trace, the
bytes kernels H1, H2 and H3 must move, the bucket hash they are counted
with, the card's published peak, and the tail statistic of the metrics.

Copied from the port's measuring tools so that a later change to the
program cannot move the yardstick: ``device_busy_us`` from
``shotgun_tpu_torch/tools/profile_align.py``, ``h1_bytes`` and
``h3_bytes`` from ``tools/bench_encode.py``, ``h2_bytes`` from
``tools/bench_probe.py``,
``mix32``/``split_key`` from ``ops/encode.py``.  Nothing here imports
the program.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

import torch

#: H100 SXM HBM3 bandwidth, bytes/s (NVIDIA's data sheet, 700 W part)
HBM_BYTES_PER_S = 3.35e12
#: Chrome-trace categories of work that occupies the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# splitmix64-derived odd constants of the table hash
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_C3 = 0x27D4EB2F
_GOLDEN = 0x9E3779B9
M32 = 0xFFFFFFFF


def merge_intervals(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as disjoint sorted ones."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def device_busy_us(trace_events: Iterable[dict]) -> float:
    """Microseconds in which the device ran at least one kernel, copy or
    memset: the union of those events' intervals in a Chrome trace."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in trace_events
             if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sum(e - s for s, e in merge_intervals(spans))


def mix32(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The table's bucket hash of uint32 (lo, hi) words held in int64
    tensors -> int64 in [0, 2**32)."""
    h = ((lo ^ _GOLDEN) * _C1) & M32
    h = h ^ (h >> 15)
    h = ((h ^ ((hi * _C2) & M32)) * _C3) & M32
    h = h ^ (h >> 13)
    h = (h * _C1) & M32
    return h ^ (h >> 16)


def split_key(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 keys -> (lo, hi) int64 tensors of the two uint32 words."""
    return keys & M32, keys >> 32


def h1_bytes(rows: int, packed_width: int, k: int, keys: bool, sums: bool) -> int:
    """Bytes H1 must move for [rows, 4 * packed_width] positions: packed
    codes in and int64 keys out (``keys``), quality bytes in and int32
    sums out (``sums``)."""
    length = 4 * packed_width
    nwin = length - k + 1
    return (rows * (packed_width + 8 * nwin) * keys
            + rows * (length + 4 * nwin) * sums)


def h3_bytes(rows: int, packed_width: int, k: int, sums: bool) -> int:
    """Bytes H3 ``encode_words`` must move for [rows, 4 * packed_width]
    positions: packed codes in and ceil(k / 31) int64 words out, and with
    ``sums`` quality bytes in and int32 sums out."""
    length = 4 * packed_width
    nwin = length - k + 1
    words = -(-k // 31)
    return (rows * (packed_width + 8 * words * nwin)
            + rows * (length + 4 * nwin) * sums)


def h2_bytes(n_buckets: int, row_bytes: int, stash_rows: int, keys: torch.Tensor
             ) -> Tuple[int, int]:
    """(bytes H2 must move, distinct buckets read) for one launch over
    ``keys``: the int64 keys, one row of each distinct bucket the keys
    hash to, the stash (16 B a row), and three int32 outputs a key."""
    lo, hi = split_key(keys.reshape(-1))
    buckets = int(torch.unique(mix32(lo, hi) & (n_buckets - 1)).numel())
    n = keys.numel()
    return n * 8 + buckets * row_bytes + stash_rows * 16 + n * 12, buckets


def bound_s(nbytes: float) -> float:
    """Least seconds to move ``nbytes`` through HBM at the published rate."""
    return nbytes / HBM_BYTES_PER_S


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the smallest value
    that at least a share ``q`` of ``values`` do not exceed."""
    xs = sorted(values)
    return xs[max(math.ceil(q * len(xs)), 1) - 1]

