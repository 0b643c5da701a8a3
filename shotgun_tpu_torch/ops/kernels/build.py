"""Build and load the port's hand-written CUDA kernels.

Route (b) of the Hopper build recipe: ``nvcc`` compiles every
``csrc/*.cu`` (plain C entry points, no PyTorch headers, so the build takes
seconds; one process a source, all started together, then one link) for
``sm_90a`` into one shared library under ``build/kernels/``
at the repository root, loaded with ``ctypes``.  Nothing is built at
import time: the first CUDA call of a kernel wrapper calls
``load_library()``, and a CPU-only machine without ``nvcc`` never gets
here.  The library is rebuilt when a source is newer than it.

The wrappers live beside their plain PyTorch versions
(``ops/encode.py`` for H1 ``encode_window`` and H3 ``encode_words``,
``ops/probe.py`` for H2 ``hash_probe``); every pointer and the stream
travel as ``c_void_p``.
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

from shotgun_tpu_torch.utils.profiling import phase

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


def sources(csrc_dir: str = CSRC_DIR) -> List[str]:
    return sorted(glob.glob(os.path.join(csrc_dir, "*.cu")))


def find_nvcc() -> str:
    cand = os.environ.get("NVCC") or shutil.which("nvcc")
    if not cand and os.path.exists("/usr/local/cuda/bin/nvcc"):
        cand = "/usr/local/cuda/bin/nvcc"
    if not cand:
        raise RuntimeError(
            "nvcc not found (set NVCC or put the CUDA toolkit on PATH); "
            "the CUDA kernels cannot be built")
    return cand


def build(force: bool = False, csrc_dir: str = CSRC_DIR,
          build_dir: str = BUILD_DIR) -> BuildResult:
    """Compile ``csrc_dir/*.cu`` into ``build_dir`` unless up to date (by
    default this checkout's ``csrc/`` into ``build/kernels/``; another
    checkout's kernels build beside it for a comparison on one card)."""
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, LIB_NAME)
    srcs = sources(csrc_dir)
    if (not force and os.path.exists(out)
            and os.path.getmtime(out) >= max(map(os.path.getmtime, srcs))):
        return BuildResult(out, 0.0, "")
    tag = f"{os.getpid()}.tmp"
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    # one nvcc a source, all at once, then one link
    objs = [os.path.join(build_dir, f"{os.path.basename(src)}.{tag}.o") for src in srcs]
    cmds = [[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", "-o", obj, src] for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    logs = [proc.communicate() for proc in procs]
    tmp = f"{out}.{tag}"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
    try:
        for cmd, proc, (stdout, stderr) in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                                   f"{' '.join(cmd)}\n{stderr}{stdout}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                               f"{' '.join(link)}\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        for path in objs + [tmp]:
            if os.path.exists(path):
                os.remove(path)
    return BuildResult(out, time.perf_counter() - t0, "".join(err for _, err in logs))


_LOCK = threading.Lock()
_LIB = None


_VP, _I64, _CI = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: each C entry point: (argument types, return type)
ENTRY_POINTS = {
    "stt_encode_window": ([_VP, _VP, _VP, _VP, _I64, _I64, _CI, _CI, _VP], _CI),
    "stt_encode_words": ([_VP, _VP, _VP, _VP, _I64, _I64, _CI, _CI, _VP], _CI),
    "stt_hash_probe": ([_VP, _VP, _I64, _CI, _VP, _CI, _VP, _VP, _VP, _I64, _CI, _VP],
                       _CI),
    "stt_error_string": ([_CI], ctypes.c_char_p),
}


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and return types on ``lib``,
    those it has (another checkout's build may predate some)."""
    for name, (args, res) in ENTRY_POINTS.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and declared for ctypes."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            with phase("kernel_build"):
                _LIB = declare(ctypes.CDLL(build().path))
    return _LIB


def check_status(lib: ctypes.CDLL, status: int, kernel: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if status != 0:
        msg = lib.stt_error_string(status).decode("ascii", "replace")
        raise RuntimeError(f"{kernel} launch failed: CUDA error {status} ({msg})")
