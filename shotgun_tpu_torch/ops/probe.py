"""Single-gather hash probe: window keys -> genome sets (counterpart of
``shotgun_tpu/ops/probe.py:39-167``).

Device half of ``index/hashtable.py``.  Each window reads its one bucket
row and compares the small overflow stash; the result contract is
``probe.py:78-84,138-144`` of the JAX package: ``(hit, set_id,
genome_count, slot_pos)``, misses give ``set_id == -1``,
``genome_count == 0``, ``slot_pos == -1``; a stash hit gets
``slot_pos = 0x7FFF0000 + i``.  ``slot_pos`` is unique per distinct
k-mer, so the within-read dedupe compares one int32; that holds only
while every flat slot position ``bucket * slots + s`` lies below the
stash's, so ``hash_probe`` refuses a table of more than 0x7FFF0000 slots.

Kernel H2 ``hash_probe`` (``ops/kernels/csrc/hash_probe.cu``) does the
bucket hash, the row read, the slot compare and the stash merge in one
pass.  ``hash_probe`` below is its wrapper: a CUDA tensor launches the
kernel (or raises); a CPU tensor takes ``hash_probe_plain``, a torch
gather of the bucket rows plus the min/max reductions of the XLA form.

Tables live on the device as int32 tensors holding the uint32 bits
(PyTorch has no usable uint32 arithmetic on the CPU); the plain form
widens them to int64 with ``& 0xFFFFFFFF``.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple, Tuple

import numpy as np
import torch

from shotgun_tpu_torch.index.hashtable import STASH_CAP, STASH_POS_BASE, slots_fit
from shotgun_tpu_torch.ops.encode import M32, mix32, split_key
from shotgun_tpu_torch.ops.kernels.build import check_status, load_library

EMPTY = 0xFFFFFFFF
#: windows per step of the plain probe (bounds its [n, slots, 4] gather)
_PLAIN_CHUNK = 1 << 20


class HashTableDev(NamedTuple):
    """Device tensors of the bucketized hash table (uint32 bits as int32)."""

    table: torch.Tensor   # int32 [n_buckets, slots, 4]
    stash: torch.Tensor   # int32 [stash_n, 4], stash_n <= STASH_CAP


def hash_table_to_device(table: np.ndarray, stash: np.ndarray,
                         device: torch.device) -> HashTableDev:
    """uint32 host arrays (``index/hashtable.py`` layout) -> HashTableDev."""
    def dev(a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
        return torch.from_numpy(a).to(device)

    return HashTableDev(table=dev(table), stash=dev(stash.reshape(-1, 4)))


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & M32


def _probe_chunk_plain(table, stash, keys):
    lo, hi = split_key(keys)
    n_buckets, slots = table.shape[0], table.shape[1]
    bidx = mix32(lo, hi) & (n_buckets - 1)
    rows = _u32(table[bidx])                               # [n, slots, 4]
    match = ((rows[..., 0] == lo[:, None]) & (rows[..., 1] == hi[:, None])
             & (rows[..., 2] != EMPTY))
    sid = torch.where(match, rows[..., 2], EMPTY).amin(dim=1)
    gc = torch.where(match, rows[..., 3], 0).amax(dim=1)
    flat = bidx[:, None] * slots + torch.arange(slots, device=keys.device)
    pos = torch.where(match, flat, EMPTY).amin(dim=1)
    if stash.shape[0]:
        st = _u32(stash)
        smatch = (st[None, :, 0] == lo[:, None]) & (st[None, :, 1] == hi[:, None])
        sid = torch.minimum(sid, torch.where(smatch, st[None, :, 2], EMPTY).amin(dim=1))
        gc = torch.maximum(gc, torch.where(smatch, st[None, :, 3], 0).amax(dim=1))
        spos = STASH_POS_BASE + torch.arange(stash.shape[0], device=keys.device)
        pos = torch.minimum(pos, torch.where(smatch, spos[None, :], EMPTY).amin(dim=1))
    hit = sid != EMPTY
    return (torch.where(hit, sid, -1).to(torch.int32), gc.to(torch.int32),
            torch.where(hit, pos, -1).to(torch.int32))


def hash_probe_plain(table: torch.Tensor, stash: torch.Tensor,
                     keys: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel H2: (set_id, genome_count, slot_pos)
    int32, shaped like ``keys``; misses -1 / 0 / -1."""
    flat = keys.reshape(-1)
    parts = [_probe_chunk_plain(table, stash, flat[i: i + _PLAIN_CHUNK])
             for i in range(0, flat.numel(), _PLAIN_CHUNK)]
    if not parts:
        empty = torch.empty(0, dtype=torch.int32, device=keys.device)
        parts = [(empty, empty, empty)]
    return tuple(torch.cat(p).reshape(keys.shape) for p in zip(*parts))


def _check_table(table: torch.Tensor, stash: torch.Tensor,
                 keys: torch.Tensor) -> None:
    if table.dtype != torch.int32 or table.dim() != 3 or table.shape[2] != 4:
        raise ValueError(f"table must be int32 [n_buckets, slots, 4], got "
                         f"{table.dtype} {tuple(table.shape)}")
    n_buckets = table.shape[0]
    if n_buckets < 1 or n_buckets & (n_buckets - 1):
        raise ValueError(f"n_buckets must be a power of two, got {n_buckets}")
    if not slots_fit(n_buckets, table.shape[1]):
        raise ValueError(f"{n_buckets} x {table.shape[1]} slots: slot positions "
                         f"would reach the stash's from {STASH_POS_BASE:#x}")
    if stash.dtype != torch.int32 or stash.dim() != 2 or stash.shape[1] != 4:
        raise ValueError(f"stash must be int32 [n, 4], got "
                         f"{stash.dtype} {tuple(stash.shape)}")
    if stash.shape[0] > STASH_CAP:
        raise ValueError(f"stash holds {stash.shape[0]} rows > {STASH_CAP}")
    if keys.dtype != torch.int64:
        raise ValueError(f"keys must be int64, got {keys.dtype}")
    if not (table.device == stash.device == keys.device):
        raise ValueError("table, stash and keys must be on one device")


def hash_probe(table: torch.Tensor, stash: torch.Tensor, keys: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel H2: int64 window keys -> (set_id, genome_count, slot_pos)
    int32 of the same shape.

    A CUDA tensor launches the kernel on the current stream (counted in
    ``hash_probe.launches``, and in ``hash_probe.launches_by_mode`` under
    "16-slot" or "4-slot"); the kernel serves the two layouts the
    references build.  A CPU tensor takes ``hash_probe_plain``, which
    serves any slot count."""
    _check_table(table, stash, keys)
    device = keys.device
    if device.type == "cpu":
        return hash_probe_plain(table, stash, keys)
    if device.type != "cuda":
        raise ValueError(f"hash_probe: unsupported device {device}")
    if table.shape[1] not in (4, 16):
        raise ValueError(f"hash_probe: the CUDA kernel takes 4 or 16 slots "
                         f"per bucket, got {table.shape[1]}")
    for t, name in ((table, "table"), (stash, "stash"), (keys, "keys")):
        if not t.is_contiguous():
            raise ValueError(f"hash_probe: {name} must be contiguous")
    outs = [torch.empty(keys.shape, dtype=torch.int32, device=device)
            for _ in range(3)]
    lib = load_library()
    # the launch sets the device; the guard gives the caller's back
    with torch.cuda.device(device):
        status = lib.stt_hash_probe(
            keys.data_ptr(), table.data_ptr(), table.shape[0], table.shape[1],
            stash.data_ptr() if stash.shape[0] else None, stash.shape[0],
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
            keys.numel(), device.index,
            torch.cuda.current_stream(device).cuda_stream)
    check_status(lib, status, "hash_probe")
    hash_probe.launches += 1
    hash_probe.launches_by_mode[f"{table.shape[1]}-slot"] += 1
    return tuple(outs)


hash_probe.launches = 0
hash_probe.launches_by_mode = Counter()


def probe_kmers(table: torch.Tensor, stash: torch.Tensor, keys: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hit bool, set_id, genome_count, slot_pos) for [B, W] int64 keys."""
    sid, gc, pos = hash_probe(table, stash, keys)
    return sid >= 0, sid, gc, pos
