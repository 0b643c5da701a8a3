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
from shotgun_tpu_torch.reference import KmerReference


def hash_table(tab, device: torch.device) -> HashTableDev:
    """A JAX ``ProbeTable`` (host) or ``HashTableDev`` (device) -> the
    port's ``HashTableDev``; both carry ``table`` and ``stash``."""
    return hash_table_to_device(np.asarray(tab.table), np.asarray(tab.stash),
                                device)


def fold_carry(carry, device: torch.device) -> FoldCarry:
    """A JAX ``FoldCarry`` -> the port's, field by field (int32)."""
    return FoldCarry(*(
        torch.from_numpy(np.array(x, dtype=np.int32)).to(device)
        for x in carry))


def reference(index: KmerIndex) -> KmerReference:
    """A ``KmerIndex`` (what a JAX ``KmerReference`` holds) -> the port's
    ``KmerReference`` over the same arrays."""
    return KmerReference(index.k, _index=index)
