"""Device selection (counterpart of ``shotgun_tpu/utils/platform.py``).

The CLI reads ``SHOTGUN_TPU_TORCH_DEVICE`` (default ``cuda``).  Asking for
CUDA on a machine without it raises: the port never carries on silently
on the CPU.  Library callers and tests pass their device explicitly.
``upload`` moves a host array to a device; ``tool_device`` is the
measuring tools' ``resolve_device``, which exits 1 where it would raise.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Union

import numpy as np
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


def tool_device(name: Optional[str], tool: str) -> torch.device:
    """``resolve_device(name)`` for a measuring tool: where that raises (no
    CUDA and no CPU asked for), the reason goes to stderr and the tool
    exits 1; it never measures on another device than the one asked for."""
    try:
        return resolve_device(name)
    except RuntimeError as exc:
        print(f"{tool}: {exc}", file=sys.stderr)
        raise SystemExit(1) from None


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on CUDA staged in pinned memory and
    copied without blocking (the caching host allocator keeps the pinned
    block alive until the copy has run); on the CPU the array's own
    memory."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
