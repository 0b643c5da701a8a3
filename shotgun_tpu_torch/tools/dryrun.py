"""Dry runs of the port's align step (counterpart of the JAX package's
``__graft_entry__.py``).

``entry()`` gives one align + aggregate step and its example arguments on
a tiny problem; ``dryrun_multichip(n)`` runs that step over an n-device
data mesh, over a DP x TP mesh (n >= 4, even), each held equal to the
single-device step, then two CLI processes joined by
``torch.distributed``, whose process 0 must print the plain golden, and
two library processes whose 1 x 2 mesh splits the table across them
(``table_axis_process``), each held equal to one device.

    python -m shotgun_tpu_torch.tools.dryrun [--devices N]

The devices are ``resolve_device()``'s: on CUDA the first n cards, or the
first card n times when fewer are visible; on the CPU
(``SHOTGUN_TPU_TORCH_DEVICE=cpu``) the CPU n times.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from shotgun_tpu_torch.aligner import PseudoAlignment
from shotgun_tpu_torch.io.data_file import FASTAFile, FASTAQFile
from shotgun_tpu_torch.models.pipeline import AggResult, aggregate_batch, align_batch
from shotgun_tpu_torch.ops.encode import pack_codes_2bit
from shotgun_tpu_torch.ops.probe_sort import sorted_table_host
from shotgun_tpu_torch.parallel import distributed
from shotgun_tpu_torch.parallel.mesh import (
    align_aggregate_sharded,
    make_mesh,
    replicate,
    shard_read_arrays,
)
from shotgun_tpu_torch.parallel.table_sharded import (
    align_aggregate_table_sharded,
    device_put_sharded_table,
    make_mesh_2d,
    shard_sorted_table,
)
from shotgun_tpu_torch.reference import KmerReference
from shotgun_tpu_torch.utils.device import resolve_device, upload
from shotgun_tpu_torch.utils.synth import synth_genomes, synth_reads

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
K = 11
#: the step's flags: no quality or max-genomes gate
GATES = dict(k=K, has_mrq=False, has_mkq=False, has_mg=False)
#: m, p, mrq, mkq, mg
PARAMS = (1, 1, 0, 0, 0)
#: a table-axis process's m, p, mrq, mkq, mg (every gate on) and batch
LIBRARY_PARAMS = (1, 1, 70, 75, 2)
LIBRARY_BATCH = 10
#: the program of a table-axis process: argv fa, fq, k, table, devices a
#: process; prints its summary as one JSON line
TABLE_AXIS_CHILD = r"""
import json, sys
from shotgun_tpu_torch.tools.dryrun import table_axis_process
fa, fq, k, table, n_local = sys.argv[1:]
print(json.dumps(table_axis_process(fa, fq, int(k), int(table), int(n_local))))
"""


def _tiny_problem(n_reads: int, device: torch.device, read_len: int = 40
                  ) -> Tuple[KmerReference, tuple]:
    """A reference of 4 random 2 kbp genomes on ``device`` and ``n_reads``
    of its reads as host arrays: (2-bit packed codes, quality, lengths,
    row_valid)."""
    rng = np.random.default_rng(0)
    genomes = synth_genomes(rng, 4, 2000)
    ref = KmerReference(K, genomes, device=device)
    reads = synth_reads(rng, genomes, n_reads, read_len)
    lpad = -(-read_len // 32) * 32
    codes = np.zeros((n_reads, lpad), dtype=np.uint8)
    codes[:, :read_len] = reads.codes
    qual = np.zeros((n_reads, lpad), dtype=np.uint8)
    qual[:, :read_len] = reads.qual
    return ref, (pack_codes_2bit(codes), qual, reads.lengths,
                 np.ones(n_reads, dtype=bool))


def entry(device: Optional[Union[str, torch.device]] = None):
    """(forward, example_args): one align + aggregate step of the port's
    pipeline on 64 reads, on ``resolve_device(device)``."""
    device = resolve_device(device)
    ref, arrays = _tiny_problem(64, device)

    def forward(probe_tab, set_member, codes, qual, lengths, row_valid,
                m, p, mrq, mkq, mg) -> AggResult:
        res = align_batch(probe_tab, set_member, codes, qual, lengths,
                          m, p, mrq, mkq, mg, **GATES)
        return aggregate_batch(res, row_valid)

    example_args = (ref.device_probe_tables(device), ref.set_member_device(device),
                    *(upload(a, device) for a in arrays), *PARAMS)
    return forward, example_args


def _require_equal(got: AggResult, want: AggResult, what: str) -> None:
    for name, g, w in zip(want._fields, got, want):
        if not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(f"dryrun {what}: {name} differs from one device")


def dryrun_multichip(n_devices: int, device: Optional[Union[str, torch.device]] = None
                     ) -> None:
    """The data-parallel step over ``n_devices`` (reads sharded, table
    replicated, counters merged by SUM and order keys by MIN), the DP x TP
    step on a (n/2) x 2 mesh when n >= 4 is even (the sorted table in 2
    key ranges), each equal to the single-device step, then the
    multi-process checks (``_dryrun_multiprocess``)."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= n_devices:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [device] * n_devices
    ref, arrays = _tiny_problem(8 * n_devices, device)
    n_reads = arrays[0].shape[0]
    member = ref.set_member_device(device)
    one = aggregate_batch(align_batch(
        ref.device_probe_tables(device), member, *(upload(a, device) for a in arrays[:3]),
        *PARAMS, **GATES), upload(arrays[3], device))

    mesh = make_mesh(devices)
    tabs, members = replicate(mesh, ref.device_probe_tables(device), member)
    agg = align_aggregate_sharded(tabs, members, *shard_read_arrays(mesh, *arrays),
                                  *PARAMS, mesh=mesh, **GATES)
    _require_equal(agg, one, "dp")
    total = int(agg.n_unique) + int(agg.n_ambiguous) + int(agg.n_unmapped)
    if total != n_reads:
        raise AssertionError(f"dryrun dp: {total} reads counted of {n_reads}")
    print(f"dryrun_multichip ok (dp): {n_devices} devices, {n_reads} reads, "
          f"unique={int(agg.n_unique)}", flush=True)

    if n_devices >= 4 and n_devices % 2 == 0:
        table_axis = 2
        mesh2 = make_mesh_2d(devices, data=n_devices // table_axis, table=table_axis)
        tab_d = device_put_sharded_table(
            mesh2, shard_sorted_table(sorted_table_host(ref.index), table_axis))
        (members2,) = replicate(mesh2, member)
        agg2 = align_aggregate_table_sharded(
            tab_d, members2, *shard_read_arrays(mesh2, *arrays), *PARAMS,
            mesh=mesh2, **GATES)
        _require_equal(agg2, one, "dp x tp")
        print(f"dryrun_multichip ok (dp x tp): {n_devices // table_axis}x{table_axis} "
              f"mesh, {n_reads} reads, unique={int(agg2.n_unique)}", flush=True)

    _dryrun_multiprocess(device)


def free_port() -> int:
    """A free TCP port of localhost, for a coordinator address."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_processes(argv: List[str], env: Dict[str, str], timeout: float = 300.0,
                  n: int = 2) -> List[Tuple[str, str]]:
    """``python argv`` from the repository root as processes 0 to n - 1 of
    an n-process run (``SHOTGUN_TPU_NPROCS=n``, a free coordinator port on
    localhost) in the environment ``env``: [(stdout, stderr)] of each.
    All must exit 0 within ``timeout``; a process still running then is
    killed."""
    port = free_port()
    procs = []
    try:
        for rank in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, *argv], cwd=REPO, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                env=dict(env, SHOTGUN_TPU_NPROCS=str(n), SHOTGUN_TPU_PROC_ID=str(rank),
                         SHOTGUN_TPU_COORDINATOR=f"localhost:{port}")))
        deadline = time.monotonic() + timeout
        outs = [proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
                for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, (_, err)) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise AssertionError(f"process {rank} exited {proc.returncode}: {err[-3000:]}")
    return outs


def table_axis_process(fa: str, fq: str, k: int, table: int, n_local: int) -> dict:
    """One process of a run that ``run_processes`` started: it joins the
    group, and aligns the reads of ``fq`` against the genomes of ``fa`` at
    ``k`` (LIBRARY_PARAMS, batches of LIBRARY_BATCH) over the job's
    ``("data", "table")`` mesh with a table axis of ``table``, ``n_local``
    devices a process (its ``rank_device`` repeated; one:
    ``global_mesh_2d``).  Returns the summary."""
    rank = int(os.environ["SHOTGUN_TPU_PROC_ID"])
    distributed.initialize(os.environ["SHOTGUN_TPU_COORDINATOR"],
                           int(os.environ["SHOTGUN_TPU_NPROCS"]), rank)
    try:
        dev = distributed.rank_device(rank)
        mesh = (distributed.global_mesh_2d(table) if n_local == 1 else make_mesh_2d(
            [dev] * n_local, table=table, group=torch.distributed.group.WORLD))
        aln = PseudoAlignment(KmerReference(k, FASTAFile(fa).container, device=dev), dev)
        aln.align_packed_reads(FASTAQFile(fq).container.to_read_batch(), *LIBRARY_PARAMS,
                               batch_size=LIBRARY_BATCH, mesh=mesh, store_reads=False)
        return aln.get_summary()
    finally:
        distributed.shutdown()


def one_device_summary(fa: str, fq: str, k: int, device: torch.device) -> dict:
    """``table_axis_process``'s alignment on ``device`` alone."""
    aln = PseudoAlignment(KmerReference(k, FASTAFile(fa).container, device=device), device)
    aln.align_packed_reads(FASTAQFile(fq).container.to_read_batch(), *LIBRARY_PARAMS,
                           batch_size=LIBRARY_BATCH, store_reads=False)
    return aln.get_summary()


def _dryrun_multiprocess(device: torch.device) -> None:
    """Two port CLI processes (``SHOTGUN_TPU_NPROCS=2``) run the plain
    golden dumpalign on ``device``'s type; process 0's stdout must end in
    the golden and process 1 must print no summary.  Then two library
    processes split the table of the golden corpus over a 1 x 2 mesh, and
    each one's summary must be the single-device one."""
    golden_dir = os.path.join(REPO, "tests", "golden")
    manifest = os.path.join(golden_dir, "manifest.json")
    if not os.path.exists(manifest):
        print("dryrun_multiprocess skipped: golden corpus not present", flush=True)
        return
    with open(manifest) as fh:
        args = [a.replace("data/", os.path.join(golden_dir, "data") + "/")
                for a in json.load(fh)["plain"]["args"]]
    env = dict(os.environ, SHOTGUN_TPU_TORCH_DEVICE=device.type)
    outs = run_processes(
        ["-m", "shotgun_tpu_torch", *args, "--batch-size", "16", "--profile"], env)
    with open(os.path.join(golden_dir, "plain.out")) as fh:
        golden = fh.read()
    if not outs[0][0].endswith(golden):
        raise AssertionError("dryrun 2-process: process 0's output differs from the golden")
    if "{" in outs[1][0]:
        raise AssertionError("dryrun 2-process: process 1 printed a summary")
    backend = outs[0][1].split("backend ", 1)[1].split()[0]
    print(f"dryrun_multichip ok (2-process torch.distributed, {backend}): "
          "process 0's dumpalign JSON == reference golden", flush=True)

    fa, fq = (os.path.join(golden_dir, "data", name) for name in ("corpus.fa", "corpus.fq"))
    outs = run_processes(["-c", TABLE_AXIS_CHILD, fa, fq, str(K), "2", "1"], env)
    want = one_device_summary(fa, fq, K, device)
    if any(json.loads(out) != want for out, _ in outs):
        raise AssertionError("dryrun table axis across 2 processes: a summary differs "
                             "from one device")
    print("dryrun_multichip ok (table axis across 2 processes, 1x2 mesh): both "
          "summaries == one device", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    dryrun_multichip(ap.parse_args().devices)


if __name__ == "__main__":
    main()
