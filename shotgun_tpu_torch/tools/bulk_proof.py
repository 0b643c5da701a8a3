"""Bulk-scale proof of the host-built database (the port's counterpart of
the JAX repo's ``tools/bulk_proof.py``, parts a, b and ab).

    python -m shotgun_tpu_torch.tools.bulk_proof [a|b|ab] [--device cuda|cpu]
        [--a-len 6250000] [--a-reads 1048576] [--batch 16384]
        [--b-records 4] [--b-len 4200000] [--b-reads 4096] [--b-min-keys 16000000]

Part A (k = 31, seed 0): 16 random genomes of ``--a-len`` bases (6.25
Mbp: 100 Mbp, about 100M distinct 31-mers) built on the host (native
C++), timed; the sort table's upload, timed; ``--a-reads`` (1,048,576)
error-free 150 bp reads written as a FASTQ; the probe table of the run's
route (``auto``: above the device's crossover, ``routes.py``, the 16-slot
table, assembled on the device under its budget), timed on its own line;
``align_stream`` of the FASTQ at ``--batch`` twice, a warm run and a timed
one; then 64 reads (drawn by the same generator) aligned by
``align_packed_reads`` with the read store, each read's type held against
the host ``Read.pseudo_align``.

Part B (k = 75, seed 1): 4 random genomes of 4.2 Mbp built on the host (at
least ``--b-min-keys`` distinct 75-mers, 3 int64 words a key on the card),
the key-sorted table split by ``shard_sorted_table(..., 1)`` and placed by
``device_put_sharded_table`` on a 1 x 1 ``("data", "table")`` mesh;
``align_aggregate_table_sharded`` of ``--b-reads`` reads must equal the
unsharded ``align_batch`` + ``aggregate_batch`` in every field.

A mismatch raises (exit non-zero).  The last line of output is one JSON
object of every number above.  ``part_a`` and ``part_b`` return theirs, part
A's also the reference and the FASTQ's path, for ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from shotgun_tpu_torch.aligner import _MTYPE_FROM_CODE, PseudoAlignment, Read
from shotgun_tpu_torch.index.build import build_index
from shotgun_tpu_torch.io.packing import pack_reads
from shotgun_tpu_torch.models.pipeline import aggregate_batch, align_batch
from shotgun_tpu_torch.ops.encode import pack_codes_2bit
from shotgun_tpu_torch.ops.probe_sort import sorted_table_host
from shotgun_tpu_torch.parallel.mesh import replicate, shard_read_arrays
from shotgun_tpu_torch.parallel.table_sharded import (
    align_aggregate_table_sharded,
    device_put_sharded_table,
    make_mesh_2d,
    shard_sorted_table,
)
from shotgun_tpu_torch.reference import KmerReference
from shotgun_tpu_torch.tools.devbuild_proof import probe_table, read_record
from shotgun_tpu_torch.tools.profile_align import _sync, stream_align, table_bytes
from shotgun_tpu_torch.utils.device import resolve_device
from shotgun_tpu_torch.utils.synth import synth_genomes, synth_reads, to_fastq

READ_LEN = 150
A_RECORDS = 16
A_SAMPLE = 64


def part_a(workdir: str, device=None, rec_len: int = 6_250_000, n_reads: int = 1_048_576,
           batch: int = 16384, log: Callable = print) -> dict:
    """Part A of the module doc on ``device`` (``resolve_device()`` by
    default), its FASTQ written into ``workdir``.  The results, with the
    reference under ``"ref"`` and the FASTQ's path under ``"fastq"``."""
    k = 31
    device = resolve_device(device)
    mbp = A_RECORDS * rec_len / 1e6
    res = {"device": str(device), "k": k, "records": A_RECORDS, "rec_len": rec_len,
           "reads": n_reads, "batch": batch}
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    genomes = synth_genomes(rng, A_RECORDS, rec_len)
    res["synth_s"] = time.perf_counter() - t0
    log(f"A: synth {mbp:g} Mbp genomes: {res['synth_s']:.3f} s")

    t0 = time.perf_counter()
    idx = build_index(genomes, k)
    res["host_build_s"] = dt = time.perf_counter() - t0
    res["num_kmers"], res["num_sets"] = idx.num_kmers, idx.num_sets
    log(f"A: host native build: {dt:.3f} s ({mbp / dt:.1f} Mbp/s, "
        f"{idx.num_kmers} k-mers, {idx.num_sets} sets)")
    ref = KmerReference(k, _index=idx, device=device)

    _sync(device)
    t0 = time.perf_counter()
    tab = ref.device_probe_tables(device, "sort")
    _sync(device)
    res["sort_table"] = {"bytes": table_bytes(tab), "rows": int(tab.sid.numel()),
                         "seconds": time.perf_counter() - t0}
    log(f"A: sort table on the device: {res['sort_table']['bytes']} B "
        f"({res['sort_table']['rows']} rows), host prep + upload "
        f"{res['sort_table']['seconds']:.3f} s")

    t0 = time.perf_counter()
    reads = synth_reads(rng, genomes, n_reads, READ_LEN)
    fq = os.path.join(workdir, "bulk.fq")
    with open(fq, "w") as fh:
        fh.write(to_fastq(reads))
    res["fastq_s"] = time.perf_counter() - t0
    res["fastq_bytes"] = os.path.getsize(fq)
    log(f"A: synth + write {n_reads} reads: {res['fastq_s']:.3f} s "
        f"({res['fastq_bytes']} B)")

    res["table"] = probe_table(ref, device, lambda msg: log("A: " + msg))

    for label in ("warm", "timed"):
        _sync(device)
        t0 = time.perf_counter()
        pa = stream_align(ref, fq, device, batch)
        _sync(device)
        dt = time.perf_counter() - t0
        summary = pa.get_summary()
        res[f"stream_{label}_s"] = dt
        log(f"A: stream align ({label}): {dt:.3f} s = {n_reads / dt:.0f} reads/s, "
            f"{summary['Statistics']}")
    res["summary"] = summary

    t0 = time.perf_counter()
    sample = rng.choice(n_reads, size=A_SAMPLE, replace=False)
    recs = [read_record(reads, int(i), f"s{i}") for i in sample]
    pa2 = PseudoAlignment(ref, device)
    pa2.align_packed_reads(pack_reads(recs), 1, 1, store_reads=True)
    got = dict(zip(pa2._read_ids, pa2._mtypes))
    mism = [rec.identifier for rec in recs
            if _MTYPE_FROM_CODE[got[rec.identifier]]
            != Read(rec).pseudo_align(ref, 1, 1)]
    res["sample_s"] = time.perf_counter() - t0
    res["sampled"], res["mismatches"] = A_SAMPLE, len(mism)
    log(f"A: sampled host-spec check: {A_SAMPLE - len(mism)}/{A_SAMPLE} match "
        f"({res['sample_s']:.3f} s)")
    if mism:
        raise AssertionError(f"A: reads {mism} differ from Read.pseudo_align")
    return dict(res, ref=ref, fastq=fq)


def part_b(device=None, n_rec: int = 4, rec_len: int = 4_200_000, n_reads: int = 4096,
           min_keys: int = 16_000_000, log: Callable = print) -> dict:
    """Part B of the module doc on ``device`` (``resolve_device()`` by
    default): the results, with both aggregations (numpy) under
    ``"sharded"`` and ``"unsharded"``."""
    k = 75
    device = resolve_device(device)
    res = {"device": str(device), "k": k, "records": n_rec, "rec_len": rec_len,
           "reads": n_reads}
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    genomes = synth_genomes(rng, n_rec, rec_len)
    idx = build_index(genomes, k)
    res["host_build_s"] = time.perf_counter() - t0
    res["num_kmers"] = idx.num_kmers
    log(f"B: k={k} host build: {res['host_build_s']:.3f} s ({idx.num_kmers} k-mers, "
        f"{idx.kmer_words.shape[1]} uint32 words a key on the host)")
    if idx.num_kmers < min_keys:
        raise AssertionError(f"B: {idx.num_kmers} k-mers < {min_keys}")
    ref = KmerReference(k, _index=idx, device=device)
    reads = synth_reads(rng, genomes, n_reads, READ_LEN)

    mesh = make_mesh_2d([device], data=1, table=1)
    parts = shard_sorted_table(sorted_table_host(idx), 1)
    _sync(device)
    t0 = time.perf_counter()
    tab_d = device_put_sharded_table(mesh, parts)
    _sync(device)
    res["sharded_table"] = {"bytes": table_bytes(tab_d[0]),
                            "words": len(tab_d[0].words),
                            "seconds": time.perf_counter() - t0}
    log(f"B: sharded table on the device: {res['sharded_table']['bytes']} B, "
        f"{res['sharded_table']['words']} int64 words a key, upload "
        f"{res['sharded_table']['seconds']:.3f} s")

    lpad = ((READ_LEN + 31) // 32) * 32
    codes = np.zeros((n_reads, lpad), dtype=np.uint8)
    codes[:, :READ_LEN] = reads.codes
    arrays = (pack_codes_2bit(codes), None, reads.lengths.astype(np.int32),
              np.ones(n_reads, dtype=bool))
    member = ref.set_member_device(device)
    (members,) = replicate(mesh, member)
    flags = dict(k=k, has_mrq=False, has_mkq=False, has_mg=False)
    _sync(device)
    t0 = time.perf_counter()
    got = align_aggregate_table_sharded(tab_d, members, *shard_read_arrays(mesh, *arrays),
                                        1, 1, 0, 0, 0, mesh=mesh, **flags)
    _sync(device)
    res["sharded_s"] = time.perf_counter() - t0

    tab = ref.device_probe_tables(device, "sort")
    one = [None if a is None else torch.from_numpy(a).to(device) for a in arrays]
    want = aggregate_batch(align_batch(tab, member, *one[:3], 1, 1, 0, 0, 0, **flags),
                           one[3])
    got, want = ({n: x.cpu().numpy() for n, x in zip(a._fields, a)} for a in (got, want))
    log(f"B: sharded probe: {res['sharded_s']:.3f} s, unique {int(got['n_unique'])}, "
        f"ambiguous {int(got['n_ambiguous'])}, unmapped {int(got['n_unmapped'])}")
    differ = [n for n in want if not np.array_equal(got[n], want[n])]
    if differ:
        raise AssertionError(f"B: sharded != unsharded in {differ}")
    log("B: sharded == unsharded aggregation (every counter, unique_by_rec, "
        "amb_by_rec, first_key)")
    return dict(res, sharded=got, unsharded=want)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="ab", choices=["a", "b", "ab"])
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default $SHOTGUN_TPU_TORCH_DEVICE or cuda)")
    ap.add_argument("--a-len", type=int, default=6_250_000)
    ap.add_argument("--a-reads", type=int, default=1_048_576)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--b-records", type=int, default=4)
    ap.add_argument("--b-len", type=int, default=4_200_000)
    ap.add_argument("--b-reads", type=int, default=4096)
    ap.add_argument("--b-min-keys", type=int, default=16_000_000)
    args = ap.parse_args(argv)
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        if "a" in args.which:
            res = part_a(tmp, args.device, args.a_len, args.a_reads, args.batch)
            out["a"] = {k: v for k, v in res.items() if k not in ("ref", "fastq")}
            del res
        if "b" in args.which:
            res = part_b(args.device, args.b_records, args.b_len, args.b_reads,
                         args.b_min_keys)
            out["b"] = {k: v for k, v in res.items() if k not in ("sharded", "unsharded")}
    print("bulk proof done", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
