"""Processes joined by ``torch.distributed`` (counterpart of
``shotgun_tpu/parallel/distributed.py``).

One process a device (or a group of devices): ``initialize`` joins the
process group, ``global_data_mesh`` gives the data mesh over every
process and ``global_mesh_2d`` the ``("data", "table")`` mesh, whose
table axis may span processes, and ``parallel.mesh`` merges the
per-genome counters and order keys with exact integer ``all_reduce``
(SUM, MIN), so dumpalign's output does not depend on the process count.
Every process holds the whole read batch in global order and aligns its
own shard of each batch; process 0 prints the summary.

The backend follows a rule, never a failed attempt: ``nccl`` when the
processes run on CUDA and each has a card of its own (``num_processes <=
torch.cuda.device_count()``), ``gloo`` otherwise (on the CPU, and for
processes that share a card, which NCCL refuses).  Process p computes on
``cuda:(p % device_count)``, or on the CPU when ``resolve_device()``
asks for it.

    from shotgun_tpu_torch.parallel import distributed
    distributed.initialize("localhost:29400", 2, rank)
    mesh = distributed.global_data_mesh()
    PseudoAlignment(ref, mesh.devices[0]).align_packed_reads(
        batch, mesh=mesh, store_reads=False)
    distributed.shutdown()
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from shotgun_tpu_torch.parallel.mesh import Mesh, make_mesh
from shotgun_tpu_torch.parallel.table_sharded import make_mesh_2d
from shotgun_tpu_torch.utils.device import resolve_device

DEFAULT_COORDINATOR = "localhost:29400"


def card_of(rank: int) -> int:
    """The card process ``rank`` computes on when the job runs on CUDA."""
    return rank % torch.cuda.device_count()


def rank_device(rank: int, device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """The device process ``rank`` computes on: ``cuda:card_of(rank)``
    when ``resolve_device(device)`` is CUDA, else it."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", card_of(rank))
    return dev


def backend_for(num_processes: int, device: torch.device) -> str:
    """``nccl`` when every process has a card of its own, else ``gloo``."""
    if device.type == "cuda" and num_processes <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str = DEFAULT_COORDINATOR,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[Union[str, torch.device]] = None) -> None:
    """Join the process group of ``num_processes`` at
    ``tcp://coordinator_address`` as ``process_id``; a no-op for one
    process.  A failure to join raises."""
    if num_processes is None or num_processes <= 1:
        return
    dev = rank_device(process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(num_processes, dev),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def initialize_from_env() -> Optional[Mesh]:
    """The CLI's mesh, from the environment (the JAX package's contract):

    * ``SHOTGUN_TPU_NPROCS`` > 1, with ``SHOTGUN_TPU_PROC_ID`` (KeyError
      when missing) and ``SHOTGUN_TPU_COORDINATOR`` (default
      ``localhost:29400``): one process of a multi-process run, which joins
      the group; the data mesh over every process;
    * ``SHOTGUN_TPU_MESH=data``: one process, the data mesh over the local
      devices;
    * neither: None (the single-device path)."""
    nprocs = os.environ.get("SHOTGUN_TPU_NPROCS")
    if nprocs and int(nprocs) > 1:
        initialize(os.environ.get("SHOTGUN_TPU_COORDINATOR", DEFAULT_COORDINATOR),
                   int(nprocs), int(os.environ["SHOTGUN_TPU_PROC_ID"]))
        return global_data_mesh()
    if os.environ.get("SHOTGUN_TPU_MESH") == "data":
        return global_data_mesh()
    return None


def global_data_mesh() -> Mesh:
    """The data mesh of the job: over the process group, one device a
    process (this process's ``rank_device``); without a group, over the
    local devices."""
    if dist.is_initialized():
        return make_mesh([rank_device(dist.get_rank())], group=dist.group.WORLD)
    return make_mesh()


def global_mesh_2d(table: int) -> Mesh:
    """The ``("data", "table")`` mesh of the job (the JAX package's
    ``make_mesh_2d()`` in a multi-process run): over the process group,
    one device a process (``rank_device``), so a table axis of ``table``
    spans that many processes; every process must call it.  Without a
    group, over the local devices."""
    if dist.is_initialized():
        return make_mesh_2d([rank_device(dist.get_rank())], table=table,
                            group=dist.group.WORLD)
    return make_mesh_2d(table=table)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def local_read_slice(total_reads: int) -> slice:
    """The contiguous slice of a global read set this process would load:
    equal shards in process order, so the global read order (and the
    Summary's dict order) is kept."""
    nproc = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = (total_reads + nproc - 1) // nproc
    start = rank * per
    return slice(start, min(start + per, total_reads))


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
