"""Data-parallel pseudo-alignment over a mesh of devices (counterpart of
``shotgun_tpu/parallel/mesh.py``).

Reads are the data-parallel axis: each device aligns its contiguous shard
of the batch against the replicated probe table, then the per-record
counters and filter counters merge by integer SUM and the first-encounter
order keys, lifted to global read order, by MIN.  So the dumpalign output
does not depend on the shard count, and equals the single-device run.

A ``Mesh`` holds this process's devices and, across processes, a
``torch.distributed`` group: the shards of one process merge on its first
device, then the processes merge by ``all_reduce`` with the same
operations, over the processes that hold other data rows only.  A device
may repeat (``[cuda:0] * 4``): one card then runs four shards, one after
another, against one copy of the table.  The JAX module's two-dispatch
hash split is a TPU-runtime workaround and has no counterpart: every
table goes through ``models.pipeline.align_batch``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from shotgun_tpu_torch.models.pipeline import (
    BIG,
    AggResult,
    aggregate_batch,
    align_batch,
    unmapped_batch,
)
from shotgun_tpu_torch.utils.device import resolve_device, upload

_I32 = torch.int32
#: AggResult's scalar counters, in the order FoldCarry.counters keeps them
_COUNTERS = ("n_unique", "n_ambiguous", "n_unmapped", "n_filtered_reads",
             "n_filtered_kmers", "n_hr_kmers")


class Mesh(NamedTuple):
    """Devices over the axes ``("data",)`` or ``("data", "table")``.

    The job's devices are row-major over the axes and process-major, as
    the JAX package's ``np.array(jax.devices()).reshape(data, table)``:
    global device g is data row ``g // table`` and table column ``g %
    table``, and process p holds the run ``[p * n, (p + 1) * n)`` of ``n =
    len(devices)``, in that order; ``shape`` holds the global axis sizes.
    A process holds whole data rows (``n % table == 0``) or part of one
    (``table % n == 0``: a row spans ``table // n`` processes).  ``group``
    is the job's process group (None: one process); ``row_group`` the
    processes of this process's data row, None when the row lies within
    it; ``col_group`` the processes at this process's place in every data
    row, over which the data axis merges, None when it lies within the
    process (``mesh_groups``)."""

    devices: Tuple[torch.device, ...]
    shape: Dict[str, int]
    group: Optional[dist.ProcessGroup] = None
    row_group: Optional[dist.ProcessGroup] = None
    col_group: Optional[dist.ProcessGroup] = None

    @property
    def table(self) -> int:
        return self.shape.get("table", 1)

    @property
    def local_table(self) -> int:
        """Table columns of this process."""
        return min(self.table, len(self.devices))

    @property
    def local_data(self) -> int:
        """Data rows of this process (whole or in part)."""
        return len(self.devices) // self.local_table

    @property
    def _first_device(self) -> int:
        """The global index of this process's first device."""
        return 0 if self.group is None else dist.get_rank(self.group) * len(self.devices)

    @property
    def first_shard(self) -> int:
        """The global index of this process's first data row."""
        return self._first_device // self.table

    @property
    def first_column(self) -> int:
        """The table column of this process's first device."""
        return self._first_device % self.table


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def local_devices(devices: Optional[Sequence] = None) -> Tuple[torch.device, ...]:
    """``devices`` as ``torch.device``s; by default every visible card, or
    the CPU when ``resolve_device()`` asks for it."""
    if devices is None:
        dev = resolve_device()
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    devs = tuple(_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def world_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def mesh_groups(group: Optional[dist.ProcessGroup], n_local: int, table: int
                ) -> Tuple[Optional[dist.ProcessGroup], Optional[dist.ProcessGroup]]:
    """(row_group, col_group) of a mesh whose processes, those of
    ``group``, hold ``n_local`` devices each over a table axis of
    ``table``.  A row that spans processes gets a group of its own, and so
    does each place in a row; every process creates every group, in one
    order, as ``torch.distributed.new_group`` requires, so every process
    of ``group`` must call this together, once a mesh."""
    if group is None:
        return None, None
    per_row = max(table // n_local, 1)
    if per_row == 1:
        return None, group
    ranks = dist.get_process_group_ranks(group)
    rows = len(ranks) // per_row
    if rows == 1:
        return group, None
    me = dist.get_rank(group)
    row_groups = [dist.new_group(ranks[d * per_row: (d + 1) * per_row]) for d in range(rows)]
    col_groups = [dist.new_group(ranks[j::per_row]) for j in range(per_row)]
    return row_groups[me // per_row], col_groups[me % per_row]


def make_mesh(devices: Optional[Sequence] = None,
              group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """A ``("data",)`` mesh over ``devices`` (``local_devices``' default),
    across the processes of ``group`` when given."""
    devs = local_devices(devices)
    return Mesh(devs, {"data": world_size(group) * len(devs)}, group,
                *mesh_groups(group, len(devs), 1))


def _to(value, device: torch.device):
    """A tensor, or a (named) tuple of them such as a probe table, on
    ``device``; what is there already is returned as it is."""
    if value is None or isinstance(value, torch.Tensor):
        return value if value is None else value.to(device)
    items = [_to(x, device) for x in value]
    return type(value)(*items) if hasattr(value, "_fields") else tuple(items)


def replicate(mesh: Mesh, *values) -> tuple:
    """Each value (a tensor, or a tuple of them such as a probe table) on
    every device of the mesh: one tuple a value, one entry a device.  A
    device that holds the value already gets that same value, and a device
    met twice one copy, so shards on one card share one table."""
    out = []
    for value in values:
        copies: Dict[torch.device, object] = {}
        for d in mesh.devices:
            if d not in copies:
                copies[d] = _to(value, d)
        out.append(tuple(copies[d] for d in mesh.devices))
    return tuple(out)


def shard_read_arrays(mesh: Mesh, *arrays) -> tuple:
    """Each device's rows of full host batches (numpy, ``[B, ...]``, B a
    multiple of the data axis; None passes through): one tuple an array,
    one entry a device.  Every process holds the whole batch and uploads
    the contiguous rows of its own data rows (every process of a row those
    of that row), so the global batch, and the merged result, are those of
    one process."""
    n = mesh.shape["data"]
    out = []
    for arr in arrays:
        if arr is None:
            out.append((None,) * len(mesh.devices))
            continue
        if arr.shape[0] % n:
            raise ValueError(f"{arr.shape[0]} rows do not split into {n} data shards")
        per = arr.shape[0] // n
        copies: Dict[tuple, torch.Tensor] = {}
        row = []
        for i, dev in enumerate(mesh.devices):
            g = mesh.first_shard + i // mesh.local_table
            if (g, dev) not in copies:
                copies[(g, dev)] = upload(arr[g * per: (g + 1) * per], dev)
            row.append(copies[(g, dev)])
        out.append(tuple(row))
    return tuple(out)


def require_group(group: Optional[dist.ProcessGroup], size: int, axis: str) -> None:
    """Raise unless ``group`` holds the ``size`` processes that the
    ``axis`` axis spans."""
    if group is None or world_size(group) != size:
        raise ValueError(f"the {axis} axis spans {size} processes, but its group is "
                         f"{'missing' if group is None else world_size(group)}")


def _all_reduce(t: torch.Tensor, op, group: dist.ProcessGroup) -> torch.Tensor:
    """``all_reduce`` of ``t`` over ``group``; gloo's operand is staged on
    the CPU (the merged tensors are O(R) a batch)."""
    if dist.get_backend(group) == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return host.to(t.device)
    dist.all_reduce(t, op=op, group=group)
    return t


def merge_data_shards(mesh: Mesh, aggs: Sequence[AggResult], rows_per_shard: int,
                      r: int) -> AggResult:
    """The global AggResult of this process's data shards' ``aggs`` (in
    data-row order), on the mesh's first device (counterpart of
    ``_lifted_psum_agg``).  Each shard's order keys ``row * (r + 2) +
    rank`` are lifted to global rows (global row = shard * rows_per_shard
    + local row; below ``BIG`` whenever the single-device keys are), then
    counters SUM and keys MIN over the shards and, where the data axis
    spans processes, over ``col_group`` (never over a row's processes,
    which hold equal results)."""
    dev = mesh.devices[0]
    sums, keys = [], []
    for d, agg in enumerate(aggs):
        offset = (mesh.first_shard + d) * rows_per_shard * (r + 2)
        fk = agg.first_key.to(torch.int64)
        keys.append(torch.where(fk < BIG, fk + offset, BIG).to(dev, _I32))
        sums.append(torch.cat([
            torch.stack([getattr(agg, name) for name in _COUNTERS]).to(_I32),
            agg.unique_by_rec, agg.amb_by_rec]).to(dev))
    total = torch.stack(sums).sum(dim=0, dtype=_I32)
    first = torch.stack(keys).amin(dim=0)
    if mesh.shape["data"] > mesh.local_data:
        require_group(mesh.col_group, mesh.shape["data"] // mesh.local_data, "data")
        total = _all_reduce(total, dist.ReduceOp.SUM, mesh.col_group)
        first = _all_reduce(first, dist.ReduceOp.MIN, mesh.col_group)
    n = len(_COUNTERS)
    return AggResult(*total[:n], unique_by_rec=total[n: n + r],
                     amb_by_rec=total[n + r:], first_key=first)


def align_aggregate_sharded(
    probe_tab,                   # per device (``replicate``); unused at k < 1
    set_member,                  # per device, bool [S, R]
    codes, qual, lengths, row_valid,  # per device (``shard_read_arrays``)
    m: int, p: int, mrq: int, mkq: int, mg: int,
    *,
    mesh: Mesh,
    k: int,
    has_mrq: bool,
    has_mkq: bool,
    has_mg: bool,
) -> AggResult:
    """Reads sharded over the mesh's data axis, the table replicated: each
    data shard runs ``align_batch`` (at k < 1 ``unmapped_batch``) and
    ``aggregate_batch`` on the first device of its row, then the shards
    merge (``merge_data_shards``).  Equal to the single-device
    ``aggregate_batch`` of the whole batch.  The loop over the shards waits
    for no device, so the devices of one process run concurrently."""
    r = set_member[0].shape[1]
    aggs = []
    for d in range(mesh.local_data):
        i = d * mesh.local_table
        if k >= 1:
            res = align_batch(probe_tab[i], set_member[i], codes[i], qual[i], lengths[i],
                              m, p, mrq, mkq, mg, k=k, has_mrq=has_mrq,
                              has_mkq=has_mkq, has_mg=has_mg)
        else:
            res = unmapped_batch(r, qual[i], lengths[i], mrq, has_mrq=has_mrq)
        aggs.append(aggregate_batch(res, row_valid[i]))
    return merge_data_shards(mesh, aggs, codes[0].shape[0], r)
