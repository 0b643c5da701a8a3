"""Micro-benchmark of the sort-join probe against the 16-slot hash probe
on one device, batch by batch.

    python -m shotgun_tpu_torch.tools.bench_sortjoin [--device cuda]
        [--keys 3300000 32000000] [--batch 32768] [--iters 20] [--seed 0]
    python -m shotgun_tpu_torch.tools.bench_sortjoin --k 75

At k = 31 (the default), for each table size: a key-sorted table of distinct random 62-bit keys,
and one batch of [B, W] window keys (W = 130: 150 bp reads on the
stream's 160-base row stride, k = 31), half of them table keys, a tenth
repeating an earlier window of their read, and 5% gated.  Each is timed
after one warm-up call:

- ``join``: ``probe_dedupe_sorted``, as the pipeline runs it (a prefix
  count of table rows finds each position's last table row);
- ``join_cummax``: the same join with that row found by ``torch.cummax``,
  the first design; its outputs must equal ``join``'s;
- the join's own steps (``join_steps``): the stable sort of the tagged
  keys, the prefix count (``torch.cumsum``), the scatter back by the
  sort's permutation and the gathers of the table rows; beside them the
  unstable sort and ``torch.cummax`` over the same rows;
- ``hash16``: the 16-slot table of the same rows (``device_hash_table``),
  kernel H2 and the hash path's first-occurrence dedupe; its hits, set
  ids, genome counts and first occurrences must equal the join's.

Beside them each table's one-time making from the same rows
(``assembly_s``, after one warm call): ``device_hash_table`` (a device
build's 16-slot table from its rows), ``index_hash_table`` (a host
index's or a ``.kdb``'s 16-slot table, uploaded a chunk at a time) and
``sorted_table`` (a host index's sort table uploaded; a device build's
is its rows).  ``run_ms`` spreads them over the ``run_batches`` batches
of a RUN_READS-read run at ``--batch``: each route's batches plus its
table, for a device build and for a host index, the inputs of the auto
crossover (``routes.py``).

At ``--k`` above 31 (multi-word keys), on the card only: the strain panel
of ``utils/synth.py`` (the one of ``chip_smoke.py`` phases 6 and 9), its
host indexes at k and at 31, and one batch of its reads on the stream's
row stride.  Timed: the word join (``probe_dedupe_sorted_words`` of
ceil(k / 31) words) beside the k = 31 join of the same reads; the word
join's outputs must equal its plain version's (the same batch through
``encode_words_plain`` and the join on the CPU).  The encodes are not
timed here: ``chip_smoke.py`` phase 4 times H1 and its composition.

Times are means over ``--iters`` calls, by CUDA events on a CUDA device;
elsewhere by the host clock, which is no device metric.  The last line is
one JSON object of every number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from shotgun_tpu_torch.aligner import _lpad
from shotgun_tpu_torch.index.build import build_index
from shotgun_tpu_torch.index.device_build import device_hash_table, index_hash_table
from shotgun_tpu_torch.models.pipeline import _first_occurrence, _window_ok
from shotgun_tpu_torch.ops.encode import encode_window, encode_words, pack_codes_2bit, word_spans
from shotgun_tpu_torch.ops.probe import probe_kmers
from shotgun_tpu_torch.ops.probe_sort import SortedTableDev, sorted_table, sorted_table_host
from shotgun_tpu_torch.ops.probe_sort2 import probe_dedupe_sorted, probe_dedupe_sorted_words
from shotgun_tpu_torch.utils.device import resolve_device
from shotgun_tpu_torch.utils.synth import READ_LEN, STRAIN_LEN, strain_panel, strain_reads

K = 31
#: windows per read: (160 - 31 + 1) on the stream's row stride
WINDOWS = 130
#: genome sets of the benchmark rows; the reads of the run that ``run_ms``
#: prices (chip_smoke's main path)
SETS = 1 << 20
RUN_READS = 524_288


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
    (tkeys,) = tab.words
    u = tkeys.shape[0]
    qtag = torch.where(query_ok.reshape(-1), (keys.reshape(-1) << 1) | 1, -1)
    sk, order = torch.sort(torch.cat([tkeys << 1, qtag]), stable=True)
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
    hit = query_ok & (row >= 0) & (tkeys[rowc] == keys)
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
    sid = torch.from_numpy(rng.integers(0, SETS, size=u, dtype=np.int32)).to(device)
    sizes = torch.from_numpy(rng.integers(1, 5, size=SETS, dtype=np.int32)).to(device)
    gc = sizes[sid.long()]
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
    return SortedTableDev((tkeys,), sid, gc), keys, query_ok


def join_steps(tab: SortedTableDev, keys: torch.Tensor, query_ok: torch.Tensor
               ) -> Dict[str, Callable[[], object]]:
    """The sort join's own steps on one-word keys, each a call on inputs
    made here once: the stable sort of the tagged keys, the prefix count
    of table rows, the scatter back by the sort's permutation, and the
    gathers of the key, set id and genome count of each window's row."""
    (tkeys,) = tab.words
    u = tkeys.numel()
    tagged = torch.cat([tkeys << 1, torch.where(
        query_ok.reshape(-1), (keys.reshape(-1) << 1) | 1, -1)])
    sk, order = torch.sort(tagged, stable=True)
    is_table = order < u
    row = torch.empty_like(order)
    row[order] = torch.cumsum(is_table, 0) - 1
    rowc = row[u:].clamp(min=0)
    return {
        "sort_stable": lambda: torch.sort(tagged, stable=True),
        "cumsum": lambda: torch.cumsum(is_table, 0),
        "scatter_restore": lambda: torch.empty_like(sk).index_put_((order,), sk),
        "gather": lambda: (tkeys[rowc], tab.sid[rowc], tab.gc[rowc]),
    }


def host_index(tab: SortedTableDev) -> SimpleNamespace:
    """The table's rows as the fields of a host ``KmerIndex`` at k = 31
    that ``index_hash_table`` and ``sorted_table_host`` read (a genome
    count is its set's size)."""
    (tkeys,) = tab.words
    sid, gc = tab.sid.cpu().numpy(), tab.gc.cpu().numpy()
    sizes = np.zeros(SETS, dtype=np.int32)
    sizes[sid] = gc
    return SimpleNamespace(k=K, kmer_words=tkeys.cpu().numpy().view(np.uint32).reshape(-1, 2),
                           set_id=sid, set_sizes=sizes, num_kmers=sid.size, num_sets=SETS,
                           genome_counts=lambda: gc)


def assembly_s(tab: SortedTableDev, device: torch.device, iters: int = 3) -> dict:
    """Seconds of each table's making from ``tab``'s rows (see the module
    doc), each the mean of ``iters`` calls after a warm one."""
    (tkeys,) = tab.words
    built = dict(keys=tkeys, sid=tab.sid, gc=tab.gc, num_kmers=tkeys.numel(),
                 num_windows=tkeys.numel())
    index = host_index(tab)
    makers = {"device_hash_table": lambda: device_hash_table(built),
              "index_hash_table": lambda: index_hash_table(index, 16, device),
              "sorted_table": lambda: sorted_table(*sorted_table_host(index), device)}
    return {name: time_ms(fn, iters, device) / 1e3 for name, fn in makers.items()}


def run_batches(batch: int) -> int:
    """The batches of a RUN_READS-read run at ``batch`` reads a batch."""
    return -(-RUN_READS // batch)


def run_ms(join_ms: float, hash16_ms: float, made_s: dict, batches: int) -> dict:
    """Milliseconds of ``batches`` batches on each route with its table's
    making, for a device build and for a host index."""
    join, h16 = batches * join_ms, batches * hash16_ms
    return {"device build, sort": join,
            "device build, hash16": h16 + 1e3 * made_s["device_hash_table"],
            "host index, sort": join + 1e3 * made_s["sorted_table"],
            "host index, hash16": h16 + 1e3 * made_s["index_hash_table"]}


def bench(tab: SortedTableDev, keys: torch.Tensor, query_ok: torch.Tensor,
          iters: int, device: torch.device) -> dict:
    """Times and equality checks of one table size (see the module doc)."""
    (tkeys,) = tab.words
    u = tkeys.numel()
    res: dict = {"keys": u, "batch": list(keys.shape)}
    want = probe_dedupe_sorted(tab, keys, query_ok)
    names = ("hit", "sid", "gc", "first_occ")
    res["cummax_equal"] = all(torch.equal(g, x) for g, x in
                              zip(join_cummax(tab, keys, query_ok), want))
    ht = device_hash_table(dict(keys=tkeys, sid=tab.sid, gc=tab.gc,
                                num_kmers=u, num_windows=u))
    if ht is None:
        raise RuntimeError("the 16-slot table of the benchmark rows was refused")
    got = hash16_join(*ht, keys, query_ok)
    res["hash16_equal"] = {n: torch.equal(g, x) for n, g, x in zip(names, got, want)}

    tagged = torch.cat([tkeys << 1, torch.where(
        query_ok.reshape(-1), (keys.reshape(-1) << 1) | 1, -1)])
    order = torch.sort(tagged, stable=True)[1]
    last = torch.where(order < u, order, -1)
    steps = {
        "join": lambda: probe_dedupe_sorted(tab, keys, query_ok),
        "join_cummax": lambda: join_cummax(tab, keys, query_ok),
        **join_steps(tab, keys, query_ok),
        "sort_unstable": lambda: torch.sort(tagged),
        "cummax": lambda: torch.cummax(last, 0),
        "hash16": lambda: hash16_join(*ht, keys, query_ok),
    }
    res["sorted_rows"] = int(tagged.numel())
    res["ms"] = {name: time_ms(fn, iters, device) for name, fn in steps.items()}
    del ht, tagged, order, last, steps
    res["assembly_s"] = assembly_s(tab, device)
    res["run_batches"] = run_batches(keys.shape[0])
    res["run_ms"] = run_ms(res["ms"]["join"], res["ms"]["hash16"], res["assembly_s"],
                           res["run_batches"])
    return res


def word_case(rng: np.random.Generator, k: int, genome_len: int, batch: int) -> dict:
    """The strain panel's host indexes at k and at 31 and one batch of its
    reads (packed codes, lengths), on the host."""
    genomes = strain_panel(rng, genome_len)
    work = strain_reads(rng, genomes, batch)
    codes = np.zeros((batch, _lpad(READ_LEN, k)), dtype=np.uint8)
    codes[:, :READ_LEN] = work.codes
    t0 = time.perf_counter()
    index = build_index(genomes, k)
    return {"index": index, "build_s": time.perf_counter() - t0,
            "index_31": build_index(genomes, 31),
            "packed": torch.from_numpy(pack_codes_2bit(codes)),
            "lengths": torch.full((batch,), READ_LEN, dtype=torch.int32)}


def word_steps(case: dict, device: torch.device) -> tuple:
    """(the timed steps by name, the word join's outputs) on ``device``:
    the join at k and the join at 31."""
    k = case["index"].k
    tab = sorted_table(*sorted_table_host(case["index"]), device)
    tab31 = sorted_table(*sorted_table_host(case["index_31"]), device)
    packed, lengths = case["packed"].to(device), case["lengths"].to(device)
    words, _ = encode_words(packed, k)
    keys, _ = encode_window(packed, 31)
    ok = _window_ok(None, lengths, k, words[0].shape[1], 0, False)
    ok31 = _window_ok(None, lengths, 31, keys.shape[1], 0, False)
    steps = {"word_join": lambda: probe_dedupe_sorted_words(tab, words, ok),
             "join_k31": lambda: probe_dedupe_sorted(tab31, keys, ok31)}
    return steps, probe_dedupe_sorted_words(tab, words, ok)


def bench_words(k: int, genome_len: int, batch: int, iters: int, seed: int,
                device: torch.device) -> dict:
    """Times and the plain-version check of ``--k`` > 31 (module doc)."""
    case = word_case(np.random.default_rng(seed), k, genome_len, batch)
    steps, got = word_steps(case, device)
    _, want = word_steps(case, torch.device("cpu"))
    names = ("hit", "sid", "gc", "first_occ")
    return {"k": k, "words": len(word_spans(k)), "batch": list(got[0].shape),
            "table_rows": case["index"].num_kmers,
            "table_rows_k31": case["index_31"].num_kmers,
            "host_build_s": case["build_s"], "hits": int(got[0].sum()),
            "plain_equal": {n: torch.equal(g.cpu(), w) for n, g, w in zip(names, got, want)},
            "ms": {name: time_ms(fn, iters, device) for name, fn in steps.items()}}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default $SHOTGUN_TPU_TORCH_DEVICE or cuda)")
    ap.add_argument("--keys", type=int, nargs="+", default=[3_300_000, 32_000_000],
                    help="table sizes in distinct keys")
    ap.add_argument("--batch", type=int, default=32768, help="reads per batch")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=31,
                    help="above 31: the strain panel's word join against its k = 31 "
                         "join, on the card")
    args = ap.parse_args(argv)

    if args.k > 31:
        if not torch.cuda.is_available():
            print("bench_sortjoin: --k above 31 needs the card; "
                  "torch.cuda.is_available() is false", file=sys.stderr)
            raise SystemExit(1)
        device = torch.device("cuda", 0)
        res = bench_words(args.k, STRAIN_LEN, args.batch, args.iters, args.seed, device)
        out = {"device": str(device), "card": torch.cuda.get_device_name(device),
               "timer": "cuda events", "runs": [res]}
        print(f"k={args.k}: {res['table_rows']} table rows ({res['table_rows_k31']} at "
              f"k=31), batch {res['batch']}, host build {res['host_build_s']:.3f} s: "
              + ", ".join(f"{name} {ms:.3f} ms" for name, ms in res["ms"].items())
              + f"; equal to the plain version {res['plain_equal']}", flush=True)
        print(json.dumps(out), flush=True)
        if not all(res["plain_equal"].values()):
            raise SystemExit("bench_sortjoin: the word join differs from its plain version")
        return out

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
            f"{res['hash16_equal']}; tables made in " + ", ".join(
                f"{name} {s:.4f} s" for name, s in res["assembly_s"].items())
            + f"; {res['run_batches']} batches with the table: " + ", ".join(
                f"{name} {ms:.3f} ms" for name, ms in res["run_ms"].items()), flush=True)
        out["runs"].append(res)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
