"""Device selection (counterpart of ``shotgun_tpu/utils/platform.py``).

The CLI reads ``SHOTGUN_TPU_TORCH_DEVICE`` (default ``cuda``).  Asking for
CUDA on a machine without it raises: the port never carries on silently
on the CPU.  Library callers and tests pass their device explicitly.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DEVICE_ENV = "SHOTGUN_TPU_TORCH_DEVICE"
DEFAULT_DEVICE = "cuda"


def resolve_device(name: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``name`` (or ``$SHOTGUN_TPU_TORCH_DEVICE``, default ``cuda``) as a
    ``torch.device``; raises RuntimeError when CUDA is asked for but absent."""
    if name is None:
        name = os.environ.get(DEVICE_ENV, DEFAULT_DEVICE)
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{name}' requested but torch.cuda.is_available() is "
            f"false; set {DEVICE_ENV}=cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device '{name}' (cuda or cpu)")
    return device
