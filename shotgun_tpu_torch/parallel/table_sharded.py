"""The key-sorted table range-partitioned over a ``table`` mesh axis
(counterpart of ``shotgun_tpu/parallel/table_sharded.py``).

When the k-mer table outgrows one device, its key-sorted rows are split
into contiguous key ranges, one a device of a ``("data", "table")`` mesh's
row.  Reads are sharded over ``data``; every device of a row sort-joins
the row's whole read shard against its own key range
(``probe_dedupe_sorted_words``), and the per-window results merge by MAX
over the row: a key lies in one range only, and a read's repeats of a key
meet in that range, so the within-read first-occurrence dedupe is exact
there.  A miss carries set id -1, genome count 0 and no first occurrence,
below every hit.  The merged windows then go through ``core_from_probe``
and ``aggregate_batch`` once a row, and the rows merge over ``data`` as in
``parallel.mesh``: counters never merge over ``table``, where every device
holds the same windows.

The port's sorted tables hold live rows only (``ops/probe_sort.py``), so
a split needs no pad rows: it cuts where the key changes, and rows of one
key (a device-built table may repeat them) stay on one shard.  One split
serves every k (the table's key words).  The bucket hash table cannot be
range-partitioned and is refused, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from shotgun_tpu_torch.models.pipeline import (
    AggResult,
    _window_ok,
    aggregate_batch,
    core_from_probe,
)
from shotgun_tpu_torch.ops.encode import encode_words
from shotgun_tpu_torch.ops.probe import HashTableDev
from shotgun_tpu_torch.ops.probe_sort import SortedTableDev
from shotgun_tpu_torch.ops.probe_sort2 import probe_dedupe_sorted_words
from shotgun_tpu_torch.parallel.mesh import (
    Mesh,
    _to,
    local_devices,
    merge_data_shards,
    world_size,
)
from shotgun_tpu_torch.reference import not_ported


def make_mesh_2d(devices: Optional[Sequence] = None, data: Optional[int] = None,
                 table: int = 1, group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """A ``("data", "table")`` mesh over this process's ``devices``
    (``mesh.local_devices``' default), across the processes of ``group``
    when given.  ``data`` and ``table`` are the global axis sizes, as in
    the JAX package (``data`` by default all the devices over ``table``);
    a table axis must lie within one process."""
    devs = local_devices(devices)
    total = world_size(group) * len(devs)
    data = total // table if data is None else data
    if data * table != total:
        raise ValueError(f"a {data} x {table} mesh needs {data * table} devices, "
                         f"have {total}")
    if len(devs) % table:
        raise not_ported(f"a table axis of {table} devices across processes of "
                         f"{len(devs)} devices each", 8)
    return Mesh(devs, {"data": data, "table": table}, group)


def _require_sorted(tab) -> None:
    if not isinstance(tab, SortedTableDev):
        raise TypeError(
            "table sharding supports the sort-merge probe only "
            f"(got {type(tab).__name__}); build the table with "
            "SHOTGUN_TPU_PROBE=sort, or keep the hash probe replicated "
            "via parallel.mesh.align_aggregate_sharded")


def shard_sorted_table(tab, n_shards: int) -> List[SortedTableDev]:
    """The key-sorted table ``tab`` (a ``SortedTableDev``, or
    ``sorted_table_host``'s ``(words, sid, gc)`` columns) as ``n_shards``
    contiguous key ranges of about equal rows, each cut where the key
    changes, so all rows of a key land on one shard (a shard may be empty).
    Rows of genome count 0 are dropped; otherwise the parts are views of
    the table's tensors, on its device (replaces the JAX package's
    ``pad_table_for_sharding`` and ``pad_table_words_for_sharding``)."""
    if isinstance(tab, HashTableDev):
        _require_sorted(tab)
    words, sid, gc = tab
    words = [torch.as_tensor(w).to(torch.int64) for w in words]
    sid = torch.as_tensor(sid).to(torch.int32)
    gc = torch.as_tensor(gc).to(torch.int32)
    live = gc > 0
    if not bool(live.all()):
        words, sid, gc = [w[live] for w in words], sid[live], gc[live]
    u, dev = sid.shape[0], sid.device
    same = torch.ones(max(u - 1, 0), dtype=torch.bool, device=dev)
    for w in words:
        same &= w[1:] == w[:-1]
    # where a cut may fall: the first row of each key, and the end
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        (~same).nonzero().flatten() + 1,
                        torch.full((1,), u, dtype=torch.int64, device=dev)])
    targets = torch.arange(1, n_shards, device=dev) * u // n_shards
    cuts = [0, *starts[torch.searchsorted(starts, targets)].tolist(), u]
    return [SortedTableDev(words=tuple(w[a:b] for w in words), sid=sid[a:b], gc=gc[a:b])
            for a, b in zip(cuts[:-1], cuts[1:])]


def device_put_sharded_table(mesh: Mesh, parts: Sequence[SortedTableDev]) -> tuple:
    """Part t of ``shard_sorted_table`` on the devices of table column t of
    every data row: one entry a device of the mesh (a device met twice for
    one part gets one copy; a part already there is not copied)."""
    if isinstance(parts, HashTableDev):
        _require_sorted(parts)
    for part in parts:
        _require_sorted(part)
    if len(parts) != mesh.table:
        raise ValueError(f"{len(parts)} table parts for a table axis of {mesh.table}")
    copies = {}
    for i, dev in enumerate(mesh.devices):
        key = (i % mesh.table, dev)
        if key not in copies:
            copies[key] = _to(parts[key[0]], dev)
    return tuple(copies[(i % mesh.table, dev)] for i, dev in enumerate(mesh.devices))


def align_aggregate_table_sharded(
    tab,                         # per device (``device_put_sharded_table``)
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
    """DP x TP pseudo-alignment (k >= 1): reads sharded over ``data``, the
    sorted table over ``table``.  Equal to the single-device
    ``aggregate_batch`` exactly, for any axis sizes.  The loops wait for
    no device."""
    for part in tab:
        _require_sorted(part)
    t = mesh.table
    aggs = []
    for d in range(mesh.local_data):
        first = d * t
        dev = mesh.devices[first]
        merged, qsum = None, None
        for i in range(first, first + t):
            words, sums = encode_words(codes[i], k, qual[i] if has_mkq else None)
            ok = _window_ok(None, lengths[i], k, words[0].shape[1], mkq, has_mkq,
                            qsum=sums)
            hit, sid, gc, first_occ = probe_dedupe_sorted_words(tab[i], words, ok)
            # a dead row (genome count 0) of a table placed without
            # shard_sorted_table is no hit
            hit = hit & (gc > 0)
            part = [x.to(dev) for x in (hit, sid, gc, first_occ & hit)]
            if merged is None:
                merged, qsum = part, sums
            else:
                merged = [merged[0] | part[0], torch.maximum(merged[1], part[1]),
                          torch.maximum(merged[2], part[2]), merged[3] | part[3]]
        hit, sid, gc, first_occ = merged
        res = core_from_probe(
            (hit, torch.where(hit, sid, -1), gc, None), set_member[first], qual[first],
            lengths[first], m, p, mrq, mkq, mg, k=k, has_mrq=has_mrq,
            has_mkq=has_mkq, has_mg=has_mg, qsum=qsum, pre_first_occ=first_occ)
        aggs.append(aggregate_batch(res, row_valid[first]))
    return merge_data_shards(mesh, aggs, codes[0].shape[0], set_member[0].shape[1])
