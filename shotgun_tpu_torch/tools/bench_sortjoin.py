"""Micro-benchmark of the sort-join probe against the 16-slot hash probe
on one device, batch by batch.

    python -m shotgun_tpu_torch.tools.bench_sortjoin [--device cuda]
        [--keys 3300000 32000000] [--batch 32768] [--iters 20] [--seed 0]

For each table size: a key-sorted table of distinct random 62-bit keys,
and one batch of [B, W] window keys (W = 130: 150 bp reads on the
stream's 160-base row stride, k = 31), half of them table keys, a tenth
repeating an earlier window of their read, and 5% gated.  Each is timed
after one warm-up call:

- ``join``: ``probe_dedupe_sorted``, as the pipeline runs it (a prefix
  count of table rows finds each position's last table row);
- ``join_cummax``: the same join with that row found by ``torch.cummax``,
  the first design; its outputs must equal ``join``'s;
- the join's steps: the stable and the unstable sort of the tagged keys,
  ``torch.cummax`` and ``torch.cumsum`` over them, and the scatter back by
  the sort's permutation;
- ``hash16``: the 16-slot table of the same rows (``device_hash_table``),
  kernel H2 and the hash path's first-occurrence dedupe; its hits, set
  ids, genome counts and first occurrences must equal the join's.

Times are means over ``--iters`` calls, by CUDA events on a CUDA device;
elsewhere by the host clock, which is no device metric.  The last line is
one JSON object of every number.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from shotgun_tpu_torch.index.device_build import device_hash_table
from shotgun_tpu_torch.models.pipeline import _first_occurrence
from shotgun_tpu_torch.ops.probe import probe_kmers
from shotgun_tpu_torch.ops.probe_sort import SortedTableDev
from shotgun_tpu_torch.ops.probe_sort2 import probe_dedupe_sorted
from shotgun_tpu_torch.utils.device import resolve_device

#: windows per read: (160 - 31 + 1) on the stream's row stride
WINDOWS = 130


def time_ms(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls after one warm-up:
    CUDA events on a CUDA device, the host clock elsewhere."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def join_cummax(tab: SortedTableDev, keys: torch.Tensor, query_ok: torch.Tensor):
    """``probe_dedupe_sorted`` with each sorted position's last table row
    found by ``torch.cummax`` over the table rows' indices (the first
    design; for comparison only).  Needs a non-empty table."""
    b, w = keys.shape
    u = tab.keys.shape[0]
    qtag = torch.where(query_ok.reshape(-1), (keys.reshape(-1) << 1) | 1, -1)
    sk, order = torch.sort(torch.cat([tab.keys << 1, qtag]), stable=True)
    is_table = order < u
    row = torch.cummax(torch.where(is_table, order, -1), 0).values
    run = sk >> 1
    qread = torch.div(order - u, w, rounding_mode="floor")
    dup = torch.zeros_like(is_table)
    dup[1:] = (run[1:] == run[:-1]) & ~is_table[:-1] & (qread[1:] == qread[:-1])

    def restore(x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x)
        out[order] = x
        return out[u:].reshape(b, w)

    row, dup = restore(row), restore(dup)
    rowc = row.clamp(min=0)
    hit = query_ok & (row >= 0) & (tab.keys[rowc] == keys)
    return (hit, torch.where(hit, tab.sid[rowc], -1),
            torch.where(hit, tab.gc[rowc], 0), hit & ~dup)


def hash16_join(table, stash, keys: torch.Tensor, query_ok: torch.Tensor):
    """The hash path's (hit, sid, gc, first_occ) for the same windows:
    kernel H2, then the first-occurrence dedupe of ``models/pipeline.py``."""
    hit, sid, gc, pos = probe_kmers(table, stash, keys)
    hit = hit & query_ok
    return (hit, torch.where(hit, sid, -1), torch.where(hit, gc, 0),
            _first_occurrence(pos, hit))


def make_case(rng: np.random.Generator, u: int, b: int, device: torch.device):
    """(table, keys [b, WINDOWS], query_ok) on ``device``."""
    draw = torch.from_numpy(rng.integers(0, 1 << 62, size=u + 64, dtype=np.int64))
    draw = torch.unique(draw.to(device))
    pick = torch.from_numpy(rng.permutation(draw.numel())[:u]).to(device)
    tkeys = torch.sort(draw[pick]).values
    sid = torch.from_numpy(rng.integers(0, 1 << 20, size=u, dtype=np.int32)).to(device)
    gc = torch.from_numpy(rng.integers(1, 5, size=u, dtype=np.int32)).to(device)
    n = b * WINDOWS
    from_table = torch.from_numpy(rng.random(n) < 0.5).to(device)
    idx = torch.from_numpy(rng.integers(0, u, size=n)).to(device)
    fresh = torch.from_numpy(rng.integers(0, 1 << 62, size=n, dtype=np.int64)).to(device)
    keys = torch.where(from_table, tkeys[idx], fresh).reshape(b, WINDOWS)
    # a tenth of the windows repeat an earlier window of their read
    rep = torch.from_numpy(rng.random((b, WINDOWS)) < 0.1).to(device)
    rep[:, 0] = False
    src = (torch.from_numpy(rng.random((b, WINDOWS))).to(device)
           * torch.arange(WINDOWS, device=device)).long()
    keys = torch.where(rep, torch.gather(keys, 1, src), keys)
    query_ok = torch.from_numpy(rng.random((b, WINDOWS)) < 0.95).to(device)
    return SortedTableDev(tkeys, sid, gc), keys, query_ok


def bench(tab: SortedTableDev, keys: torch.Tensor, query_ok: torch.Tensor,
          iters: int, device: torch.device) -> dict:
    """Times and equality checks of one table size (see the module doc)."""
    u = tab.keys.numel()
    res: dict = {"keys": u, "batch": list(keys.shape)}
    want = probe_dedupe_sorted(tab, keys, query_ok)
    names = ("hit", "sid", "gc", "first_occ")
    res["cummax_equal"] = all(torch.equal(g, x) for g, x in
                              zip(join_cummax(tab, keys, query_ok), want))
    ht =device_hash_table(dict(keys=tab.keys, sid=tab.sid, gc=tab.gc,
                                num_kmers=u, num_windows=u))
    if ht is None:
        raise RuntimeError("the 16-slot table of the benchmark rows was refused")
    got = hash16_join(*ht, keys, query_ok)
    res["hash16_equal"] = {n: torch.equal(g, x) for n, g, x in zip(names, got, want)}

    tagged = torch.cat([tab.keys << 1, torch.where(
        query_ok.reshape(-1), (keys.reshape(-1) << 1) | 1, -1)])
    sk, order = torch.sort(tagged, stable=True)
    is_table = order < u
    last = torch.where(is_table, order, -1)
    steps = {
        "join": lambda: probe_dedupe_sorted(tab, keys, query_ok),
        "join_cummax": lambda: join_cummax(tab, keys, query_ok),
        "sort_stable": lambda: torch.sort(tagged, stable=True),
        "sort_unstable": lambda: torch.sort(tagged),
        "cummax": lambda: torch.cummax(last, 0),
        "cumsum": lambda: torch.cumsum(is_table, 0),
        "scatter_restore": lambda: torch.empty_like(sk).index_put_((order,), sk),
        "hash16": lambda: hash16_join(*ht, keys, query_ok),
    }
    res["sorted_rows"] = int(sk.numel())
    res["ms"] = {name: time_ms(fn, iters, device) for name, fn in steps.items()}
    return res


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default $SHOTGUN_TPU_TORCH_DEVICE or cuda)")
    ap.add_argument("--keys", type=int, nargs="+", default=[3_300_000, 32_000_000],
                    help="table sizes in distinct keys")
    ap.add_argument("--batch", type=int, default=32768, help="reads per batch")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    out: dict = {"device": str(device), "timer": (
        "cuda events" if device.type == "cuda" else "host clock, not a device metric")}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    rng = np.random.default_rng(args.seed)
    out["runs"] = []
    for u in args.keys:
        res = bench(*make_case(rng, u, args.batch, device), args.iters, device)
        print(f"{u} keys, {res['sorted_rows']} sorted rows: " + ", ".join(
            f"{name} {ms:.3f} ms" for name, ms in res["ms"].items())
            + f"; cummax join equal {res['cummax_equal']}, hash16 equal "
            f"{res['hash16_equal']}", flush=True)
        out["runs"].append(res)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
