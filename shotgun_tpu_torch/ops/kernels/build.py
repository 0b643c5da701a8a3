"""Build and load the port's hand-written CUDA kernels.

Route (b) of the Hopper build recipe: ``nvcc`` compiles every
``csrc/*.cu`` (plain C entry points, no PyTorch headers, so the build takes
seconds) for ``sm_90a`` into one shared library under ``build/kernels/``
at the repository root, loaded with ``ctypes``.  Nothing is built at
import time: the first CUDA call of a kernel wrapper calls
``load_library()``, and a CPU-only machine without ``nvcc`` never gets
here.  The library is rebuilt when a source is newer than it.

The wrappers live beside their plain PyTorch versions
(``ops/encode.py`` for H1 ``encode_window``, ``ops/probe.py`` for H2
``hash_probe``); every pointer and the stream travel as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import List, NamedTuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
#: csrc -> kernels -> ops -> shotgun_tpu_torch -> the repository root
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(CSRC_DIR))))
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
LIB_NAME = "libshotgun_tpu_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


class BuildResult(NamedTuple):
    path: str
    seconds: float   # 0.0 when an up-to-date library was reused
    log: str         # nvcc's stderr (ptxas register / shared-memory report)


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def find_nvcc() -> str:
    cand = os.environ.get("NVCC") or shutil.which("nvcc")
    if not cand and os.path.exists("/usr/local/cuda/bin/nvcc"):
        cand = "/usr/local/cuda/bin/nvcc"
    if not cand:
        raise RuntimeError(
            "nvcc not found (set NVCC or put the CUDA toolkit on PATH); "
            "the CUDA kernels cannot be built")
    return cand


def build(force: bool = False) -> BuildResult:
    """Compile ``csrc/*.cu`` into ``build/kernels/`` unless up to date."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, LIB_NAME)
    srcs = sources()
    if (not force and os.path.exists(out)
            and os.path.getmtime(out) >= max(map(os.path.getmtime, srcs))):
        return BuildResult(out, 0.0, "")
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, *srcs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return BuildResult(out, time.perf_counter() - t0, proc.stderr)


_LOCK = threading.Lock()
_LIB = None


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and declared for ctypes."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build().path)
            vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.stt_encode_window.argtypes = [vp, vp, vp, vp, i64, i64, ci, ci, vp]
            lib.stt_encode_window.restype = ci
            lib.stt_hash_probe.argtypes = [vp, vp, i64, ci, vp, ci, vp, vp, vp,
                                           i64, ci, vp]
            lib.stt_hash_probe.restype = ci
            lib.stt_error_string.argtypes = [ci]
            lib.stt_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def check_status(lib: ctypes.CDLL, status: int, kernel: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if status != 0:
        msg = lib.stt_error_string(status).decode("ascii", "replace")
        raise RuntimeError(f"{kernel} launch failed: CUDA error {status} ({msg})")
