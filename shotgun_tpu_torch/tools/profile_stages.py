"""Per-stage device time of one batch through ``models/pipeline.py
align_batch`` (the port's counterpart of the JAX repo's
``tools/profile_stages.py``, the sort route, and ``tools/profile_hash.py``,
the hash route, in one tool).

    python -m shotgun_tpu_torch.tools.profile_stages [--probe sort|hash|hash16]
        [--device cuda|cpu] [--iters 20]

On the JAX tools' data -- 5 random genomes of 200 kbp and one batch of
B = 16384 error-free 150 bp reads of them from ``default_rng(0)``, k = 31,
the host build -- each stage runs alone on inputs already on the device:

1. ``encode``: on the sort route ``encode_words`` and the window mask
   (``_window_ok``), on the hash routes ``encode_window`` (kernel H1 on
   both);
2. ``probe``: the sort join (``probe_dedupe_sorted_words``: kernel H4 on
   the card) whole, then the plain join's steps as
   ``tools/bench_sortjoin.py join_steps`` gives them (``probe.sort_stable``,
   ``probe.cumsum``, ``probe.scatter_restore``, ``probe.gather``); or
   ``probe_kmers`` (kernel H2) on the 4-slot
   (``hash``) or 16-slot (``hash16``) host-built table;
3. ``classify``: ``core_from_probe``.  On the hash routes it holds the
   within-read dedupe, which is also timed alone (``dedupe``:
   ``_first_occurrence``); the sort join makes its own;
4. ``aggregate``: ``aggregate_batch``;
5. ``fused``: ``align_fold_batch``, the stream's batch, whole.

The JAX tool's "2a main 2-key sort" and "2b restore sort" time a carry
layout the port does not have, so the sort join's steps are the port's.
Each stage is timed over ``--iters`` calls after one warm call: CUDA
events around the calls on the card, the host clock on the CPU (no
device metric).  A stage is many small launches, so that time holds the
host's dispatch; on the card each stage's device time is also taken, as
the busy time of a ``torch.profiler`` trace of ``--iters`` more calls.
The sum of stages 1-4 is printed against the fused time (both in device
time on the card), with reads/s at the fused time; the last line is one
JSON object.
Exits 1 where CUDA is absent unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from shotgun_tpu_torch.aligner import _lpad
from shotgun_tpu_torch.index.build import build_index
from shotgun_tpu_torch.models.pipeline import (
    _first_occurrence,
    _window_ok,
    aggregate_batch,
    align_fold_batch,
    core_from_probe,
    init_fold_carry,
)
from shotgun_tpu_torch.ops.encode import encode_window, encode_words, pack_codes_2bit
from shotgun_tpu_torch.ops.probe import probe_kmers
from shotgun_tpu_torch.ops.probe_sort import SortedTableDev
from shotgun_tpu_torch.ops.probe_sort2 import probe_dedupe_sorted_words
from shotgun_tpu_torch.reference import KmerReference
from shotgun_tpu_torch.tools.bench_sortjoin import join_steps, time_ms
from shotgun_tpu_torch.tools.profile_align import profiled, table_bytes
from shotgun_tpu_torch.utils.device import tool_device
from shotgun_tpu_torch.utils.synth import synth_genomes, synth_reads

K = 31
READ_LEN = 150
BATCH = 16384
N_GENOMES = 5
GENOME_LEN = 200_000
ITERS = 20
#: the dumpalign defaults: m = 1, p = 1, no quality or max-genomes gate
GATES = (1, 1, 0, 0, 0)
NO_GATES = dict(k=K, has_mrq=False, has_mkq=False, has_mg=False)
#: the stages that add up to a batch (the others are parts of them, or all)
SUMMED = ("encode", "probe", "classify", "aggregate")


def make_data(batch: int = BATCH, n_genomes: int = N_GENOMES,
              genome_len: int = GENOME_LEN):
    """(genomes, reads): the JAX tools' data, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    genomes = synth_genomes(rng, n_genomes, genome_len)
    return genomes, synth_reads(rng, genomes, batch, READ_LEN)


def stage_reads(codes: np.ndarray, lengths: np.ndarray, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reads [N, L] as the stream stages them, on ``device``: the codes on
    the row stride of k = 31, zero-padded and 2-bit packed, and the int32
    lengths."""
    padded = np.zeros((codes.shape[0], _lpad(codes.shape[1], K)), dtype=np.uint8)
    padded[:, : codes.shape[1]] = codes
    return (torch.from_numpy(pack_codes_2bit(padded)).to(device),
            torch.from_numpy(np.ascontiguousarray(lengths, dtype=np.int32)).to(device))


def stages(tab, member: torch.Tensor, packed: torch.Tensor, lengths: torch.Tensor
           ) -> Tuple[Dict[str, Callable[[], object]], Dict[str, object]]:
    """The stages of the module doc on the table's route: {name: call}, each
    on inputs already on the device (the outputs of the stage before), and
    {name: output of one call}."""
    calls: Dict[str, Callable[[], object]] = {}
    outs: Dict[str, object] = {}

    def stage(name: str, fn: Callable[[], object]):
        calls[name] = fn
        outs[name] = fn()
        return outs[name]

    if isinstance(tab, SortedTableDev):
        def encode():
            words, _ = encode_words(packed, K)
            return words, _window_ok(None, lengths, K, words[0].shape[1], 0, False)

        words, ok = stage("encode", encode)
        hit, sid, gc, first_occ = stage(
            "probe", lambda: probe_dedupe_sorted_words(tab, words, ok))
        for name, fn in join_steps(tab, words[0], ok).items():
            stage(f"probe.{name}", fn)
        res = stage("classify", lambda: core_from_probe(
            (hit, sid, gc, None), member, None, lengths, *GATES,
            pre_first_occ=first_occ, **NO_GATES))
    else:
        keys = stage("encode", lambda: encode_window(packed, K)[0])
        probe = stage("probe", lambda: probe_kmers(tab.table, tab.stash, keys))
        res = stage("classify", lambda: core_from_probe(
            probe, member, None, lengths, *GATES, **NO_GATES))
        stored = probe[0] & _window_ok(None, lengths, K, keys.shape[1], 0, False)
        stage("dedupe", lambda: _first_occurrence(probe[3], stored))
    stage("aggregate", lambda: aggregate_batch(res, lengths > 0))
    carry = init_fold_carry(member.shape[1], packed.device)
    stage("fused", lambda: align_fold_batch(carry, tab, member, packed, None, lengths,
                                            *GATES, **NO_GATES))
    return calls, outs


def profile(tab, member: torch.Tensor, packed: torch.Tensor, lengths: torch.Tensor,
            iters: int, log: Callable[[str], None] = print) -> dict:
    """Each stage's ms a call (``stages``; ``time_ms``) and, on CUDA, its
    device ms a call (the busy time of a ``torch.profiler`` trace of
    ``iters`` calls, ``profile_align.profiled``); the sum of stages 1-4 and
    the fused stage in the device ms where there are any; reads/s at the
    fused stage."""
    calls, _ = stages(tab, member, packed, lengths)
    dev = packed.device
    ms: Dict[str, float] = {}
    device_ms: Dict[str, float] = {}
    for name, fn in calls.items():
        ms[name] = time_ms(fn, iters, dev)
        line = f"{name:34s} {ms[name]:8.3f} ms"
        if dev.type == "cuda":
            trace = profiled(lambda: [fn() for _ in range(iters)], dev, None, name)
            device_ms[name] = trace["device_busy_ms"] / iters
            line += f"  device {device_ms[name]:8.3f} ms"
        log(line)
    by = device_ms or ms
    total = sum(by[name] for name in SUMMED)
    rate = packed.shape[0] / by["fused"] * 1e3
    log(f"sum of stages: {total:.3f} ms  (fused: {by['fused']:.3f} ms)")
    log(f"reads/s at fused: {rate:,.0f}")
    return {"ms": ms, "device_ms": device_ms or None, "sum_ms": total,
            "fused_ms": by["fused"], "reads_per_s_at_fused": rate}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", choices=("sort", "hash", "hash16"), default="sort")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default $SHOTGUN_TPU_TORCH_DEVICE or cuda)")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    device = tool_device(args.device, "profile_stages")

    genomes, reads = make_data()
    ref = KmerReference(K, _index=build_index(genomes, K), device=device)
    tab = ref.device_probe_tables(device, args.probe)
    member = ref.set_member_device(device)
    packed, lengths = stage_reads(reads.codes, reads.lengths, device)
    out = {"device": str(device), "timer": (
        "cuda events" if device.type == "cuda" else "host clock, not a device metric"),
        "probe": args.probe, "table": type(tab).__name__, "table_bytes": table_bytes(tab),
        "num_kmers": int(ref.index.num_kmers), "batch": list(packed.shape), "k": K}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    print(f"device: {out.get('card', device)}  B={packed.shape[0]} L={READ_LEN} K={K}  "
          f"{args.probe}: {out['table']} of {out['num_kmers']:,} keys, "
          f"{out['table_bytes']:,} B", flush=True)
    out.update(profile(tab, member, packed, lengths, args.iters,
                       lambda msg: print(msg, flush=True)))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
