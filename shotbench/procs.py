"""A cell over several cards: one process a card, joined by the program's
``parallel.distributed``.

A configuration that carries ``"mesh": {"data": d, "table": t}`` runs as
d x t processes.  The command's process (``launch``) starts them, process
p on card p, and holds the rendezvous store itself: it binds a port the
system picks and keeps it until every process has ended, so no other
program can take the port between its choice and its use (the children
join as the store's clients, as the processes of an elastic agent do).
It waits for all of them, ends the others as soon as one fails, and ends
them all past its deadline, so a run never hangs.  Process 0's result
line is the run's.

Each process (``join``) joins the group through
``parallel.distributed.initialize``, takes its mesh from
``global_mesh_2d(t)``, and talks to the others over a gloo group of the
harness's own: a barrier after set-up, process 0's decision to stop after
each request, and the gather of every process's answers and readings.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: seconds a multi-process run may take before its processes are ended,
#: under the 1,200 a cell's first run in a checkout may take
DEADLINE_S = 1140.0
#: how often the launching process looks at its children, seconds
POLL_S = 0.1


@dataclass
class Procs:
    """This process's place in a multi-process run."""

    rank: int
    world: int
    tmp: str                  # the run's directory, shared by every process
    group: Any                # the harness's gloo group
    mesh: Any                 # the program's ("data", "table") mesh

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def agree(self, stop: bool) -> bool:
        """Process 0's ``stop``, on every process: one small broadcast."""
        flag = torch.tensor([int(stop)], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=self.group)
        return bool(flag.item())

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Every process's ``obj`` in rank order on process 0; None on the
        others."""
        out = [None] * self.world if self.primary else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def close(self) -> None:
        from shotgun_tpu_torch.parallel import distributed

        distributed.shutdown()


def join(rank: int, world: int, port: int, tmp: str, mesh: dict) -> Procs:
    """Join the run of ``world`` processes whose store listens on
    ``localhost:port`` as process ``rank``."""
    from shotgun_tpu_torch.parallel import distributed

    distributed.initialize(f"localhost:{port}", world, rank)
    group = dist.new_group(backend="gloo")
    program_mesh = distributed.global_mesh_2d(mesh["table"])
    if program_mesh.shape.get("data") != mesh["data"]:
        raise ValueError(f"the program's mesh {program_mesh.shape} is not the "
                         f"configuration's {mesh}")
    return Procs(rank, world, tmp, group, program_mesh)


def launch(child: Sequence[str], argv: Sequence[str], world: int,
           deadline_s: float = DEADLINE_S) -> Tuple[int, Optional[str]]:
    """Run ``child + argv`` as processes 0 .. world - 1 of one run (each
    also given ``--rank``, ``--world``, ``--store-port`` and ``--tmp``)
    and wait for all.  Returns (exit code, process 0's last line of
    standard output): the code is 0 only when every process exited 0.
    The others' standard output goes to standard error."""
    store = dist.TCPStore("localhost", 0, world, is_master=True, wait_for_workers=False)
    env = dict(os.environ, TORCHELASTIC_USE_AGENT_STORE="True")
    tmp = tempfile.mkdtemp(prefix="shotbench-")
    procs: List[subprocess.Popen] = []
    outs = [os.path.join(tmp, f"stdout_{p}.txt") for p in range(world)]
    try:
        for p in range(world):
            with open(outs[p], "w") as fh:
                procs.append(subprocess.Popen(
                    [*child, *argv, "--rank", str(p), "--world", str(world),
                     "--store-port", str(store.port), "--tmp", tmp],
                    stdout=fh, env=env, start_new_session=True))
        rc = _wait(procs, time.monotonic() + deadline_s)
        lines = []
        for p, path in enumerate(outs):
            with open(path) as fh:
                text = fh.read().splitlines()
            if p:
                sys.stderr.write("".join(f"[process {p}] {x}\n" for x in text))
            lines.append(text[-1] if text else None)
        return rc, lines[0] if rc == 0 else None
    finally:
        _end(procs)
        del store
        shutil.rmtree(tmp, ignore_errors=True)


def _wait(procs: List[subprocess.Popen], deadline: float) -> int:
    """Wait until every process has exited 0 (returns 0), or one has
    failed or the deadline passed: the rest are ended, and the first
    failure's code (or 124 at the deadline) is returned."""
    while True:
        codes = [p.poll() for p in procs]
        failed = [c for c in codes if c not in (None, 0)]
        if not failed and all(c == 0 for c in codes):
            return 0
        late = time.monotonic() > deadline
        if failed or late:
            _end(procs)
            if failed:
                print(f"shotbench: a process exited {failed[0]}; the run's others "
                      f"were ended", file=sys.stderr, flush=True)
                return failed[0] if failed[0] > 0 else 1
            print("shotbench: the run's processes passed their deadline and were "
                  "ended", file=sys.stderr, flush=True)
            return 124
        time.sleep(POLL_S)


def _end(procs: List[subprocess.Popen]) -> None:
    """End every process still running, with whatever it started (each
    leads a session of its own), and wait for each."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()
