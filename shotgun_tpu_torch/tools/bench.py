"""Benchmark: pseudo-align throughput of the port on one device (the port's
counterpart of the JAX repo's ``bench.py``, with its workload, its
section order and its metric definitions).

    python -m shotgun_tpu_torch.tools.bench [--device cuda|cpu]
        [--probe sort|hash|hash16] [--genomes 5] [--genome-len 200000]
        [--reads 524288] [--batch 32768] [--passes 7] [--devbuild-mbp 32]

The workload is BASELINE.md's: 5 random genomes of 200 kbp (1 Mbp),
k = 31, 524,288 error-free 150 bp reads of them from ``default_rng(0)``,
no filters, batches of B = 32768.  The reference tool's CPU baseline on
it is 4,900 reads/s.  Sections, in order (logs on stderr):

1. data: the genomes and reads; the host build timed on its second call
   (``db_build_mbp_per_sec``, ``db_build_vs_baseline`` against 0.05 Mbp/s);
2. stream: the reads written as a FASTQ, one warm ``align_stream`` pass,
   then ``--passes`` timed passes of lazy open + ``PseudoAlignment`` +
   ``align_stream`` + ``get_summary`` (``end_to_end_reads_per_sec``, the
   median pass; ``_best``; ``e2e_pass_times_s``; ``end_to_end_vs_baseline``
   against 4,900 reads/s); every pass's summary must equal the first's;
3. align task: a warm ``store_reads=True`` pass and save, then a timed
   pass, ``.aln`` save and ``PseudoAlignment.load`` + summary, which must
   equal the stream's (``align_task_*``, ``dumpalign_a_s``);
4. staged: the ``--probe`` table, the reads staged on the device in
   batches of B, one first batch (``first_batch_s``), then every batch
   through ``align_batch`` + ``aggregate_batch`` with one synchronisation
   at the end: ``value`` (reads/s) and ``kmer_probes_per_sec`` (reads/s x
   120 windows); the totals must equal the stream's when B divides the
   reads;
5. ``stage_profile_ms``: ``profile_stages.profile`` of the first staged
   batch on the same table (a stage's ms a call; on the card also
   ``stage_profile_device_ms``, its device busy time a call);
6. device build (``db_build_device_*``): ``from_device_build`` warm, best
   of 3, on the bench's genomes; then at ``--devbuild-mbp`` over 8 records,
   with the ``auto`` probe table's assembly seconds and type, and over 1024
   records;
7. multi-device: with more than one card, weak scaling (B reads a card,
   one card against all) through ``parallel/mesh.py
   align_aggregate_sharded`` on the replicated sort table
   (``multichip``); otherwise the plumbing check (``multichip_cpu8``): 8
   CPU shards at the JAX bench's small size, whose merged totals must
   equal one device's, with no efficiency;
8. kernels (CUDA only): H1 on the first batch, H2 on the staged route's
   hash table (the 16-slot host table of the same reference on the sort
   route, which has none), each with its bytes, its byte bound at
   3.35 TB/s and its share (``tools/bench_encode.py``,
   ``tools/bench_probe.py``);
9. cold start (CUDA only): the kernels' ``nvcc`` build into a temporary
   directory, then the walls of two ``python -m shotgun_tpu_torch -t
   dumpalign -g`` children on a 3 x 30 kbp, 4,096-read corpus, whose
   outputs must be equal.

Stdout carries only the headline line, ``{"metric":
"pseudo_align_reads_per_sec_k31", "value", "unit": "reads/s",
"vs_baseline", "extra"}``, printed after section 5 and again after each
later section, so the last line holds every number; ``extra.device`` is
the card's name and power limit (``nvidia-smi``).  A section that fails
adds ``extra.error``, prints the line and exits 1; nothing falls back to
another device.  On ``--device cpu`` sections 8 and 9 record "not run:
cpu", and every time is the host's clock, no device metric.  Exits 1
where CUDA is absent unless ``--device cpu`` is given.

The flags replace the JAX bench's ``BENCH_GENOMES``, ``BENCH_GENOME_LEN``,
``BENCH_READS``, ``BENCH_BATCH``, ``BENCH_DEVBUILD_MBP`` and
``SHOTGUN_TPU_PROBE`` (``--probe``); ``--passes`` is its fixed 7 and
``--device`` its platform.  k = 31 and L = 150 are fixed by the metric's
name.  Its slot override, Pallas A/B switch, cache-warm probe and child
modes have no counterpart: the kernels section times the port's
kernels, and sections 6-9 run in this process (section 9's CLI runs in
children).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from shotgun_tpu_torch.aligner import PseudoAlignment
from shotgun_tpu_torch.index.build import build_index
from shotgun_tpu_torch.io.data_file import open_fastq_stream
from shotgun_tpu_torch.models.pipeline import AggResult, aggregate_batch, align_batch
from shotgun_tpu_torch.ops.encode import encode_window
from shotgun_tpu_torch.ops.kernels.build import build
from shotgun_tpu_torch.ops.probe import HashTableDev, hash_probe
from shotgun_tpu_torch.parallel.mesh import (
    align_aggregate_sharded,
    make_mesh,
    replicate,
    shard_read_arrays,
)
from shotgun_tpu_torch.reference import KmerReference
from shotgun_tpu_torch.tools import profile_stages
from shotgun_tpu_torch.tools.bench_encode import bound_ms, h1_bytes, kept_ms
from shotgun_tpu_torch.tools.bench_probe import h2_bytes
from shotgun_tpu_torch.tools.profile_align import _sync, table_bytes, timed_s
from shotgun_tpu_torch.utils.device import tool_device
from shotgun_tpu_torch.utils.synth import synth_genomes, synth_reads, to_fasta, write_fastq

METRIC = "pseudo_align_reads_per_sec_k31"
BASELINE_READS_PER_SEC = 4900.0
BASELINE_BUILD_MBP_PER_SEC = 0.05
K = 31
READ_LEN = 150
#: k-mer windows of a read, the probes a read makes
WINDOWS = READ_LEN - K + 1
#: calls a stage is timed over in section 5 (the JAX bench's 8)
STAGE_ITERS = 8
#: launches a kernel is timed over in section 8
KERNEL_ITERS = 100
#: section 7's plumbing check: the JAX bench's multichip_cpu8 child sizes
CPU8 = dict(devices=8, reads_per_device=16384, genomes=3, genome_len=30_000)
#: section 9's corpus: the JAX bench's warm-compile probe's
COLD = dict(genomes=3, genome_len=30_000, reads=4096)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card(device: torch.device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True).stdout
    name, limit = line.strip().rsplit(", ", 1)
    return {"name": name, "power_limit": limit}


def launches() -> Dict[str, int]:
    """The kernels' launch counts so far in this process."""
    return {"encode_window": encode_window.launches, "hash_probe": hash_probe.launches}


def since(before: Dict[str, int]) -> Dict[str, int]:
    return {name: n - before[name] for name, n in launches().items()}


def sharded_run(devices, ref: KmerReference, reads, rows: int):
    """(AggResult, seconds) of ``rows`` reads as one batch sharded over a
    data mesh of ``devices``, the sort table replicated (timed warm)."""
    mesh = make_mesh(devices)
    tab, member = replicate(mesh, ref.device_probe_tables(mesh.devices[0], "sort"),
                            ref.set_member_device(mesh.devices[0]))
    packed, lengths = profile_stages.stage_reads(reads.codes[:rows], reads.lengths[:rows],
                                                 torch.device("cpu"))
    shards = shard_read_arrays(mesh, packed.numpy(), None, lengths.numpy(),
                               np.ones(rows, dtype=bool))

    def run():
        return align_aggregate_sharded(tab, member, *shards, 1, 1, 0, 0, 0, mesh=mesh,
                                       k=K, has_mrq=False, has_mkq=False, has_mg=False)

    run()
    agg, dt = timed_s(run, mesh.devices[0])
    agg = AggResult(*(t.cpu() for t in agg))
    if int(agg.n_unique + agg.n_ambiguous + agg.n_unmapped) != rows:
        raise AssertionError(f"the sharded run counted {agg} for {rows} reads")
    return agg, dt


class Bench:
    """The sections of the module doc over one run's state; ``head`` is
    the headline line, filled as the sections go."""

    def __init__(self, args: argparse.Namespace, device: torch.device, tmp: str) -> None:
        self.args = args
        self.device = device
        self.tmp = tmp
        self.head = {"metric": METRIC, "value": None, "unit": "reads/s",
                     "vs_baseline": None, "extra": {"device": card(device)}}
        self.extra = self.head["extra"]
        self.extra["timer"] = ("host clock up to a device synchronisation; kernels by "
                               "CUDA events" if device.type == "cuda"
                               else "host clock, not a device metric")
        self.extra["kernel_launches"] = {}

    def emit(self) -> None:
        print(json.dumps(self.head), flush=True)

    def data(self) -> None:
        a = self.args
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        self.genomes = synth_genomes(rng, a.genomes, a.genome_len)
        self.reads = synth_reads(rng, self.genomes, a.reads, READ_LEN)
        log(f"synth data: {time.perf_counter() - t0:.2f} s")
        # the first call warms the native library and the pages; the
        # second is the build-once regime a .kdb amortizes
        build_index(self.genomes, K)
        t0 = time.perf_counter()
        index = build_index(self.genomes, K)
        build_s = time.perf_counter() - t0
        mbp = self.genomes.codes.size / 1e6
        self.extra.update(db_build_mbp_per_sec=mbp / build_s,
                          db_build_vs_baseline=mbp / build_s / BASELINE_BUILD_MBP_PER_SEC,
                          num_kmers=int(index.num_kmers))
        log(f"DB build (warm): {build_s:.3f} s ({mbp / build_s:.2f} Mbp/s, "
            f"{index.num_kmers} k-mers, {index.num_sets} sets)")
        self.ref = KmerReference(K, _index=index, device=self.device)

    def _align(self, store_reads: bool = False) -> PseudoAlignment:
        pa = PseudoAlignment(self.ref, self.device)
        pa.align_stream(open_fastq_stream(self.fq, lazy=True), 1, 1,
                        batch_size=self.args.batch, store_reads=store_reads)
        return pa

    def stream(self) -> None:
        n = self.args.reads
        self.fq = os.path.join(self.tmp, "bench.fq")
        t0 = time.perf_counter()
        write_fastq(self.fq, self.reads.codes, self.reads.qual)
        log(f"fastq write: {time.perf_counter() - t0:.2f} s "
            f"({os.path.getsize(self.fq) / 1e6:.0f} MB)")
        self._align()  # warm
        times, before = [], launches()
        for rep in range(self.args.passes):
            t0 = time.perf_counter()
            summary = self._align().get_summary()
            times.append(time.perf_counter() - t0)
            if rep == 0:
                self.summary = summary
            elif summary != self.summary:
                raise AssertionError(f"stream pass {rep + 1}'s summary differs from pass 1's")
            log(f"end-to-end stream pass {rep + 1}/{self.args.passes}: {times[-1]:.3f} s "
                f"({n / times[-1]:,.0f} reads/s)")
        self.extra["kernel_launches"]["stream"] = since(before)
        stats = self.summary["Statistics"]
        if sum(stats.values()) != n:
            raise AssertionError(f"the stream's statistics {stats} do not add up to {n}")
        # the median is the steady-state claim; the best pass the low-jitter bound
        self.e2e_s = sorted(times)[len(times) // 2]
        self.extra.update(
            end_to_end_reads_per_sec=n / self.e2e_s,
            end_to_end_reads_per_sec_best=n / min(times),
            e2e_pass_times_s=times,
            end_to_end_vs_baseline=n / self.e2e_s / BASELINE_READS_PER_SEC,
            stream_statistics=stats)
        log(f"end-to-end stream: {n / self.e2e_s:,.0f} reads/s median of "
            f"{len(times)} (best {n / min(times):,.0f}); {stats}")

    def align_task(self) -> None:
        n = self.args.reads
        aln = os.path.join(self.tmp, "bench.aln")
        self._align(store_reads=True).save(aln)  # warm, the save too
        pa, align_s = timed_s(lambda: self._align(store_reads=True), self.device)
        _, save_s = timed_s(lambda: pa.save(aln), self.device)
        t0 = time.perf_counter()
        summary = PseudoAlignment.load(aln, self.device).get_summary()
        dump_s = time.perf_counter() - t0
        if summary != self.summary:
            raise AssertionError("the align task's summary differs from the stream's")
        task_s = align_s + save_s
        self.extra.update(
            align_task_reads_per_sec=n / task_s, align_task_s=task_s,
            align_task_align_s=align_s, align_task_save_s=save_s, dumpalign_a_s=dump_s,
            align_task_vs_stream=task_s / self.e2e_s, align_task_summary_equal=True)
        log(f"align task: align {align_s:.3f} s + save {save_s:.3f} s = {task_s:.3f} s "
            f"({n / task_s:,.0f} reads/s, {task_s / self.e2e_s:.2f}x stream); "
            f"dumpalign -a {dump_s:.3f} s")

    def staged(self) -> None:
        a, dev = self.args, self.device
        t0 = time.perf_counter()
        self.tab = self.ref.device_probe_tables(dev, a.probe)
        self.member = self.ref.set_member_device(dev)
        _sync(dev)
        self.extra["probe_table"] = {
            "method": a.probe, "type": type(self.tab).__name__,
            "bytes": table_bytes(self.tab), "prep_s": time.perf_counter() - t0}
        log(f"probe table: {self.extra['probe_table']}")
        n_batches = a.reads // a.batch
        rows = n_batches * a.batch
        (packed, lengths), staging_s = timed_s(lambda: profile_stages.stage_reads(
            self.reads.codes[:rows], self.reads.lengths[:rows], dev), dev)
        valid = torch.ones(a.batch, dtype=torch.bool, device=dev)
        self.batches = [(packed[i: i + a.batch], lengths[i: i + a.batch])
                        for i in range(0, rows, a.batch)]
        log(f"staging {n_batches} batches: {staging_s:.3f} s")

        def run_batch(codes, lens):
            res = align_batch(self.tab, self.member, codes, None, lens, 1, 1, 0, 0, 0,
                              k=K, has_mrq=False, has_mkq=False, has_mg=False)
            return aggregate_batch(res, valid)

        _, first_s = timed_s(lambda: run_batch(*self.batches[0]), dev)
        before = launches()
        results, align_s = timed_s(lambda: [run_batch(*b) for b in self.batches], dev)
        self.extra["kernel_launches"]["staged"] = since(before)
        self.results = [AggResult(*(t.cpu() for t in r)) for r in results]
        rate = rows / align_s
        totals = {name: int(sum(int(getattr(r, f"n_{name}")) for r in self.results))
                  for name in ("unique", "ambiguous", "unmapped")}
        stats = self.summary["Statistics"]
        if rows == a.reads and totals != {
                "unique": stats["unique_mapped_reads"],
                "ambiguous": stats["ambiguous_mapped_reads"],
                "unmapped": stats["unmapped_reads"]}:
            raise AssertionError(f"staged totals {totals} differ from the stream's {stats}")
        self.head.update(value=rate, vs_baseline=rate / BASELINE_READS_PER_SEC)
        self.extra.update(kmer_probes_per_sec=rate * WINDOWS, first_batch_s=first_s,
                          staged_batches=n_batches, staged_totals=totals)
        log(f"staged: {rows} reads in {align_s:.3f} s: {rate:,.0f} reads/s, "
            f"{rate * WINDOWS / 1e6:,.1f} M probes/s; first batch {first_s:.3f} s; {totals}")

    def stage_profile(self) -> None:
        packed, lengths = self.batches[0]
        res = profile_stages.profile(self.tab, self.member, packed, lengths, STAGE_ITERS,
                                     lambda msg: log(f"stage {msg}"))
        self.extra["stage_profile_ms"] = res["ms"]
        self.extra["stage_profile_device_ms"] = res["device_ms"]

    def devbuild(self) -> None:
        dev = self.device
        rng = np.random.default_rng(0)

        def best_of_3(genomes):
            KmerReference.from_device_build(genomes, K, dev)
            best, ref = float("inf"), None
            for _ in range(3):
                ref, dt = timed_s(lambda: KmerReference.from_device_build(genomes, K, dev),
                                  dev)
                best = min(best, dt)
            if ref is None:
                raise RuntimeError("the device build refused the bench's genomes")
            mbp = genomes.codes.size / 1e6
            log(f"device build {mbp:g} Mbp / {genomes.num_records} records (warm): "
                f"{best:.4f} s ({mbp / best:.1f} Mbp/s, {ref.index.num_kmers} k-mers, "
                f"{ref.index.num_sets} sets)")
            return mbp / best, ref

        rate, _ = best_of_3(synth_genomes(rng, self.args.genomes, self.args.genome_len))
        self.extra.update(db_build_device_mbp_per_sec=rate,
                          db_build_device_vs_baseline=rate / BASELINE_BUILD_MBP_PER_SEC)
        mbp = self.args.devbuild_mbp
        if not mbp:
            return
        rate, dref = best_of_3(synth_genomes(rng, 8, mbp * 1_000_000 // 8))
        tab, assembly_s = timed_s(lambda: dref.device_probe_tables(dev, "auto"), dev)
        self.extra.update(db_build_device_bulk_mbp_per_sec=rate,
                          db_build_device_hash_assembly_s=assembly_s,
                          db_build_device_auto_table=type(tab).__name__)
        log(f"auto table at {mbp} Mbp: {type(tab).__name__} in {assembly_s:.3f} s")
        del dref, tab
        rate, _ = best_of_3(synth_genomes(rng, 1024, mbp * 1_000_000 // 1024))
        self.extra["db_build_device_r1024_mbp_per_sec"] = rate

    def multichip(self) -> None:
        n_cards = torch.cuda.device_count() if self.device.type == "cuda" else 0
        if n_cards > 1:
            per = self.args.batch
            ref, reads = self._mesh_data(self.args.genomes, self.args.genome_len,
                                         per * n_cards)
            _, t1 = sharded_run([torch.device("cuda", 0)], ref, reads, per)
            _, tn = sharded_run([torch.device("cuda", i) for i in range(n_cards)],
                                ref, reads, per * n_cards)
            res = {"n_devices": n_cards, "reads_per_device": per, "scaling_mode": "weak",
                   "reads_per_sec_1dev": per / t1,
                   "reads_per_sec_total": per * n_cards / tn,
                   "reads_per_sec_per_chip": per / tn,
                   "scaling_efficiency": t1 / tn}
            self.extra["multichip"] = res
        else:
            c = CPU8
            rows = c["devices"] * c["reads_per_device"]
            ref, reads = self._mesh_data(c["genomes"], c["genome_len"], rows)
            cpu = torch.device("cpu")
            one, t1 = sharded_run([cpu], ref, reads, rows)
            shards, tn = sharded_run([cpu] * c["devices"], ref, reads, rows)
            equal = all(torch.equal(x, y) for x, y in zip(shards, one))
            if not equal:
                raise AssertionError(f"{c['devices']} CPU shards' totals differ from one "
                                     "device's")
            res = {"n_devices": c["devices"], "reads": rows, "plumbing_check_only": True,
                   "totals_equal_one_device": equal, "one_device_s": t1,
                   "sharded_s": tn, "totals": {name: int(getattr(one, f"n_{name}")) for name
                                               in ("unique", "ambiguous", "unmapped")},
                   "note": "CPU shards run one after another on this host's cores: "
                           "the right code at the wrong speed, so no efficiency"}
            self.extra["multichip_cpu8"] = res
        log(f"multi-device: {res}")

    def _mesh_data(self, n_genomes: int, genome_len: int, n_reads: int):
        """The JAX bench's multichip data (``default_rng(3)``): a host-built
        reference on this device and the reads."""
        rng = np.random.default_rng(3)
        genomes = synth_genomes(rng, n_genomes, genome_len)
        reads = synth_reads(rng, genomes, n_reads, READ_LEN)
        return KmerReference(K, _index=build_index(genomes, K), device=self.device), reads

    def kernels(self) -> None:
        if self.device.type != "cuda":
            self.extra["kernels"] = "not run: cpu"
            return
        packed = self.batches[0][0]
        keys = encode_window(packed, K)[0]
        nbytes = h1_bytes(packed.shape[0], packed.shape[1], K, True, False)
        h1 = {"shape": [packed.shape[0], 4 * packed.shape[1]], "mode": "keys",
              "bytes": nbytes, "bound_ms": bound_ms(nbytes),
              "ms": kept_ms(lambda: encode_window(packed, K), keys.numel() * 8,
                            KERNEL_ITERS)}
        tab = self.tab
        route = self.args.probe
        if not isinstance(tab, HashTableDev):
            tab, route = self.ref.device_probe_tables(self.device, "hash16"), "hash16"
        nbytes, buckets = h2_bytes(tab.table, tab.stash, keys)
        h2 = {"table": list(tab.table.shape), "table_route": route,
              "stash": tab.stash.shape[0], "probes": keys.numel(),
              "distinct_buckets": buckets, "bytes": nbytes, "bound_ms": bound_ms(nbytes),
              "ms": kept_ms(lambda: hash_probe(tab.table, tab.stash, keys),
                            keys.numel() * 12, KERNEL_ITERS)}
        for res in (h1, h2):
            res["bound_share"] = res["bound_ms"] / res["ms"]
        self.extra["kernels"] = {"encode_window": h1, "hash_probe": h2,
                                 "hbm_bytes_per_s": 3.35e12}
        log(f"kernels: {self.extra['kernels']}")

    def cold_start(self) -> None:
        if self.device.type != "cuda":
            self.extra["cold_start"] = "not run: cpu"
            return
        res = {"kernel_build_s": build(force=True, build_dir=os.path.join(
            self.tmp, "kernels")).seconds}
        rng = np.random.default_rng(7)
        genomes = synth_genomes(rng, COLD["genomes"], COLD["genome_len"])
        reads = synth_reads(rng, genomes, COLD["reads"], READ_LEN)
        fa, fq = os.path.join(self.tmp, "cold.fa"), os.path.join(self.tmp, "cold.fq")
        with open(fa, "w") as fh:
            fh.write(to_fasta(genomes))
        write_fastq(fq, reads.codes, reads.qual)
        cmd = [sys.executable, "-m", "shotgun_tpu_torch", "-t", "dumpalign", "-g", fa,
               "-k", str(K), "--reads", fq]
        env = dict(os.environ, SHOTGUN_TPU_TORCH_DEVICE=str(self.device))
        outs = []
        for label in ("first", "second"):
            t0 = time.perf_counter()
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                                 env=env, cwd=REPO)
            res[f"cli_{label}_s"] = time.perf_counter() - t0
            if out.returncode != 0:
                raise RuntimeError(f"the {label} CLI child exited {out.returncode}: "
                                   f"{out.stderr[-500:]}")
            outs.append(out.stdout)
        if outs[0] != outs[1] or not outs[0]:
            raise AssertionError("the two CLI children printed different summaries")
        res["output_identical"] = True
        self.extra["cold_start"] = res
        log(f"cold start: {res}")


#: the sections in order; the headline is printed after the fifth and
#: after every later one
SECTIONS = ("data", "stream", "align_task", "staged", "stage_profile", "devbuild",
            "multichip", "kernels", "cold_start")
FIRST_EMIT = SECTIONS.index("stage_profile")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default $SHOTGUN_TPU_TORCH_DEVICE or cuda)")
    ap.add_argument("--probe", choices=("sort", "hash", "hash16"), default="sort",
                    help="the staged section's probe table")
    ap.add_argument("--genomes", type=int, default=5)
    ap.add_argument("--genome-len", type=int, default=200_000)
    ap.add_argument("--reads", type=int, default=524_288)
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--passes", type=int, default=7, help="timed stream passes")
    ap.add_argument("--devbuild-mbp", type=int, default=32,
                    help="the device build's large size; 0 skips it")
    return ap


def run(args: argparse.Namespace) -> Bench:
    """Every section on ``args.device``, printing the headline as the
    module doc says; the finished ``Bench``.  A failing section prints
    its traceback on stderr, the headline with ``extra.error``, and exits
    1."""
    device = tool_device(args.device, "bench")
    with tempfile.TemporaryDirectory() as tmp:
        bench = Bench(args, device, tmp)
        log(f"device: {bench.extra['device']}, torch {torch.__version__}")
        for i, name in enumerate(SECTIONS):
            t0 = time.perf_counter()
            try:
                getattr(bench, name)()
            except Exception as exc:
                traceback.print_exc()
                bench.extra["error"] = f"{name}: {exc!r}"
                bench.emit()
                raise SystemExit(1) from exc
            log(f"[{name}] {time.perf_counter() - t0:.3f} s")
            if i >= FIRST_EMIT:
                bench.emit()
    return bench


def main(argv: Optional[List[str]] = None) -> dict:
    return run(parser().parse_args(argv)).head


if __name__ == "__main__":
    main()
