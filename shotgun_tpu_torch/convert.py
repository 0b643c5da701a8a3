"""State carried across from the JAX package to the port.

Each function takes the JAX package's object with its arrays as numpy
(or anything ``np.asarray`` reads, such as a fetched jax array) and
returns the port's counterpart on ``device``.  The tests use these to
feed both packages identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from shotgun_tpu.index.build import KmerIndex
from shotgun_tpu_torch.models.pipeline import FoldCarry
from shotgun_tpu_torch.ops.probe import HashTableDev, hash_table_to_device
from shotgun_tpu_torch.ops import probe_sort
from shotgun_tpu_torch.reference import KmerReference


def hash_table(tab, device: torch.device) -> HashTableDev:
    """A JAX ``ProbeTable`` (host) or ``HashTableDev`` (device) -> the
    port's ``HashTableDev``; both carry ``table`` and ``stash``."""
    return hash_table_to_device(np.asarray(tab.table), np.asarray(tab.stash),
                                device)


def _keys(klo, khi) -> np.ndarray:
    return (np.asarray(khi).astype(np.int64) << 32) | np.asarray(klo).astype(np.int64)


def sorted_table(tab, device: torch.device) -> probe_sort.SortedTableDev:
    """A JAX ``SortedTableDev`` -> the port's, without its dead rows
    (``gc == 0``: shape-bucket pads and invalid device-build windows)."""
    return probe_sort.sorted_table(_keys(tab.klo, tab.khi), np.array(tab.sid),
                                   np.array(tab.gc), device)


def device_build(built: dict, device: torch.device) -> dict:
    """A JAX ``device_build_tables`` dict -> the port's: live rows only
    and one row per distinct key (the JAX table keeps one per window)."""
    tab = probe_sort.sorted_table(_keys(built["klo"], built["khi"]),
                                  np.array(built["sid"]), np.array(built["gc"]), device)
    first = torch.ones_like(tab.keys, dtype=torch.bool)
    first[1:] = tab.keys[1:] != tab.keys[:-1]
    return dict(keys=tab.keys[first], sid=tab.sid[first], gc=tab.gc[first],
                num_kmers=int(built["num_kmers"]), num_sets=int(built["num_sets"]),
                set_masks=np.asarray(built["set_masks"]),
                num_records=int(built["num_records"]),
                num_windows=int(built["klo"].shape[0]), prep_s=built["prep_s"])


def fold_carry(carry, device: torch.device) -> FoldCarry:
    """A JAX ``FoldCarry`` -> the port's, field by field (int32)."""
    return FoldCarry(*(
        torch.from_numpy(np.array(x, dtype=np.int32)).to(device)
        for x in carry))


def reference(index: KmerIndex) -> KmerReference:
    """A ``KmerIndex`` (what a JAX ``KmerReference`` holds) -> the port's
    ``KmerReference`` over the same arrays."""
    return KmerReference(index.k, _index=index)
