"""The database built on the device at 100 Mbp, its probe table and a
streamed-size alignment against it, cross-checked against the host build
(the port's counterpart of the JAX repo's ``tools/devbuild_proof.py``).

    python -m shotgun_tpu_torch.tools.devbuild_proof [MBP] [N_READS]
        [--device cuda|cpu] [--batch 16384]
        [--check-records 8] [--check-len 500000] [--check-reads 512]
        [--sample 32]

On 64 random genomes of MBP (default 100) Mbp in all and
N_READS (default 262,144) error-free 150 bp reads of them (``utils.synth``
from seed 0, the JAX script's data), one line each:

- ``KmerReference.from_device_build`` at k = 31, cold and then warm;
- the probe table of ``$SHOTGUN_TPU_PROBE``'s route (``auto`` by default:
  the 16-slot table above 8M distinct k-mers unless its assembly is over
  ``$SHOTGUN_TPU_HASH_HBM_BUDGET``, then the sort join): its type, bytes
  and making time;
- ``align_packed_reads`` of every read at ``--batch`` without the read
  store, and its reads/s;
- the cross-check at reduced size (8 genomes x 500 kbp, 512 reads, seeds
  1 and 2): the host build's and the device build's summaries must be
  equal, and for ``--sample`` reads (seed 3) the host ``Read.pseudo_align``
  type must equal the device path's read-store type.

A mismatch raises (exit non-zero).  The last line of output is one JSON
object of every number above.  ``run`` returns it with the references and
reads, for ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from shotgun_tpu_torch.aligner import _MTYPE_FROM_CODE, PseudoAlignment, Read
from shotgun_tpu_torch.io.records import SeqRecord
from shotgun_tpu_torch.reference import PROBE_ENV, KmerReference
from shotgun_tpu_torch.tools.profile_align import _sync, table_bytes
from shotgun_tpu_torch.utils.device import resolve_device
from shotgun_tpu_torch.utils.synth import synth_genomes, synth_reads

K = 31
N_REC = 64
READ_LEN = 150
_ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)


def make_data(mbp: float, n_reads: int):
    """(genomes, reads): N_REC random genomes of ``mbp`` Mbp in all and
    ``n_reads`` error-free reads of them, from one generator of seed 0."""
    rng = np.random.default_rng(0)
    genomes = synth_genomes(rng, N_REC, int(mbp * 1_000_000) // N_REC)
    return genomes, synth_reads(rng, genomes, n_reads, READ_LEN)


def device_build(genomes, device: torch.device, log: Callable = print) -> tuple:
    """(reference, cold s, warm s): two device builds of ``genomes``."""
    times, ref = [], None
    for label in ("cold", "warm"):
        _sync(device)
        t0 = time.perf_counter()
        ref = KmerReference.from_device_build(genomes, K, device)
        _sync(device)
        times.append(time.perf_counter() - t0)
        if ref is None:
            raise AssertionError("the device build refused the genomes")
        mbp = genomes.codes.size / 1e6
        log(f"device build {mbp:g} Mbp ({label}): {times[-1]:.3f} s "
            f"({mbp / times[-1]:.1f} Mbp/s, {ref.index.num_kmers} k-mers)")
    return ref, times[0], times[1]


def probe_table(ref: KmerReference, device: torch.device, log: Callable = print) -> dict:
    """The reference's probe table on ``device`` by the run's route: its
    route, type, bytes and making time."""
    _sync(device)
    t0 = time.perf_counter()
    tab = ref.device_probe_tables(device)
    _sync(device)
    out = {"method": ref.probe_method(), "type": type(tab).__name__,
           "bytes": table_bytes(tab), "seconds": time.perf_counter() - t0}
    if hasattr(tab, "table"):
        out["shape"] = list(tab.table.shape)
    log(f"probe table ({os.environ.get(PROBE_ENV, 'auto')}): {out['type']} "
        f"({out['method']}), {out['bytes']} B, made in {out['seconds']:.3f} s")
    return out


def align(ref: KmerReference, reads, device: torch.device, batch: int,
          log: Callable = print) -> dict:
    """``align_packed_reads`` of every read without the read store: the
    summary, seconds and reads/s."""
    pa = PseudoAlignment(ref, device)
    _sync(device)
    t0 = time.perf_counter()
    pa.align_packed_reads(reads, 1, 1, batch_size=batch, store_reads=False)
    _sync(device)
    dt = time.perf_counter() - t0
    summary = pa.get_summary()
    s = summary["Statistics"]
    log(f"aligned {reads.num_reads} reads in {dt:.3f} s "
        f"({reads.num_reads / dt:.0f} reads/s): unique {s['unique_mapped_reads']}, "
        f"ambiguous {s['ambiguous_mapped_reads']}, unmapped {s['unmapped_reads']}")
    return {"summary": summary, "seconds": dt, "reads_per_s": reads.num_reads / dt}


def read_record(reads, i: int, rid: str) -> SeqRecord:
    """Read ``i`` of a ``ReadBatch`` as a FASTQ record named ``rid``."""
    n = int(reads.lengths[i])
    return SeqRecord([("identifier", rid),
                      ("sequence", _ACGTN[reads.codes[i, :n]].tobytes().decode()),
                      ("space", ""),
                      ("quality_sequence", reads.qual[i, :n].tobytes().decode())])


def cross_check(device: torch.device, n_rec: int = 8, rec_len: int = 500_000,
                n_reads: int = 512, n_sample: int = 32, log: Callable = print) -> dict:
    """The host and the device build of one reduced corpus align to equal
    summaries, and ``n_sample`` reads' host ``Read.pseudo_align`` types
    equal the device path's."""
    small = synth_genomes(np.random.default_rng(1), n_rec, rec_len)
    sreads = synth_reads(np.random.default_rng(2), small, n_reads, READ_LEN)
    href = KmerReference(K, small, device=device)
    dref = KmerReference.from_device_build(small, K, device)
    pa_h = PseudoAlignment(href, device)
    pa_h.align_packed_reads(sreads, 1, 1, store_reads=False)
    pa_d = PseudoAlignment(dref, device)
    pa_d.align_packed_reads(sreads, 1, 1, store_reads=True)
    if pa_h.get_summary() != pa_d.get_summary():
        raise AssertionError("cross-check: host and device build summaries differ")
    idxs = np.random.default_rng(3).choice(n_reads, size=n_sample, replace=False)
    mism = []
    for i in idxs:
        want = Read(read_record(sreads, int(i), f"r{i}")).pseudo_align(href, 1, 1)
        if _MTYPE_FROM_CODE[pa_d._mtypes[int(i)]] != want:
            mism.append(int(i))
    if mism:
        raise AssertionError(f"cross-check: reads {mism} differ from Read.pseudo_align")
    log(f"cross-check ({n_rec} x {rec_len} bp, {n_reads} reads): host == device "
        f"summary, {n_sample}/{n_sample} sampled reads == Read.pseudo_align")
    return {"summary": pa_d.get_summary(), "sampled": n_sample, "mismatches": 0,
            "num_kmers": href.index.num_kmers}


def run(mbp: float = 100, n_reads: int = 262_144, device=None, batch: int = 16384,
        check: Optional[dict] = None, log: Callable = print) -> dict:
    """Every step of the module doc on ``device`` (``resolve_device()`` by
    default) under the route of ``$SHOTGUN_TPU_PROBE``; ``check`` holds
    ``cross_check``'s size arguments.  The results, and under ``"ref"``,
    ``"genomes"`` and ``"reads"`` the warm reference and the data."""
    device = resolve_device(device)
    genomes, reads = make_data(mbp, n_reads)
    ref, cold, warm = device_build(genomes, device, log)
    res = {"device": str(device), "mbp": mbp, "records": N_REC, "reads": n_reads,
           "batch": batch, "num_kmers": int(ref.index.num_kmers),
           "build_cold_s": cold, "build_warm_s": warm,
           "table": probe_table(ref, device, log)}
    res["align"] = align(ref, reads, device, batch, log)
    res["cross_check"] = cross_check(device, log=log, **(check or {}))
    return dict(res, ref=ref, genomes=genomes, reads=reads)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mbp", nargs="?", type=float, default=100)
    ap.add_argument("n_reads", nargs="?", type=int, default=262_144)
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default $SHOTGUN_TPU_TORCH_DEVICE or cuda)")
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--check-records", type=int, default=8)
    ap.add_argument("--check-len", type=int, default=500_000)
    ap.add_argument("--check-reads", type=int, default=512)
    ap.add_argument("--sample", type=int, default=32)
    args = ap.parse_args(argv)
    check = dict(n_rec=args.check_records, rec_len=args.check_len,
                 n_reads=args.check_reads, n_sample=args.sample)
    res = run(args.mbp, args.n_reads, args.device, args.batch, check)
    out = {k: v for k, v in res.items() if k not in ("ref", "genomes", "reads")}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
