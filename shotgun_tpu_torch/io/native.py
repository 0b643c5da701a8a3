"""ctypes bindings for the port's native strict parser and k-mer builder
(``io/csrc/shotgun_io.cpp``, ``io/csrc/kmer_build.cpp``; a copy of the
JAX package's ``io/native.py`` and the C++ it loads).

The shared library is built on first use with ``g++`` (the flags of the
JAX package's ``native/Makefile``) into ``build/host/`` at the repository
root, and rebuilt when a source is newer.  It is written to a temporary
file and moved into place, so processes that build at the same time never
load half a file.  ``SHOTGUN_TPU_NATIVE=0`` turns it off.  The native
scanner is byte-exact with the regex engine for ASCII input and returns
structured error codes that map onto the same exception types and
messages; non-ASCII input or a missing toolchain falls back to the Python
regex path transparently.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from shotgun_tpu_torch.utils.profiling import PROFILER, phase

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
#: csrc -> io -> shotgun_tpu_torch -> the repository root
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(CSRC_DIR)))
BUILD_DIR = os.path.join(_REPO, "build", "host")
LIB_PATH = os.path.join(BUILD_DIR, "libshotgun_tpu_torch_io.so")
SOURCES = tuple(os.path.join(CSRC_DIR, f) for f in ("shotgun_io.cpp", "kmer_build.cpp"))
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread"]

STATUS_OK = 0
STATUS_NO_RECORDS = 1
STATUS_DUPLICATE_ID = 2
STATUS_UNPARSED = 3
STATUS_LEN_MISMATCH = 4
STATUS_NON_ASCII = 5

_lib = None
_lib_failed = False


def build_library() -> str:
    """Compile ``SOURCES`` into ``LIB_PATH`` unless it is up to date;
    returns the path.  Raises when ``g++`` fails or is missing."""
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= max(map(os.path.getmtime, SOURCES))):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, *SOURCES],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB_PATH


def library_path() -> Optional[str]:
    """The loaded library's file, or None when it is not loaded."""
    return LIB_PATH if _load() is not None else None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    if os.environ.get("SHOTGUN_TPU_NATIVE", "1") == "0":
        _lib_failed = True
        return None
    try:
        lib = ctypes.CDLL(build_library())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.stpu_fastq_scan.restype = ctypes.c_int
        lib.stpu_fastq_scan.argtypes = [u8p, ctypes.c_int64, i64p]
        lib.stpu_fastq_fill.restype = ctypes.c_int
        lib.stpu_fastq_fill.argtypes = [
            u8p, ctypes.c_int64, u8p, u8p, i32p, ctypes.c_int64, i64p, u8p,
            i32p]
        lib.stpu_fasta_scan.restype = ctypes.c_int
        lib.stpu_fasta_scan.argtypes = [u8p, ctypes.c_int64, i64p]
        lib.stpu_fasta_fill.restype = ctypes.c_int
        lib.stpu_fasta_fill.argtypes = [u8p, ctypes.c_int64, u8p, i64p, i64p, u8p]
        lib.stpu_fastq_vstream_open.restype = ctypes.c_void_p
        lib.stpu_fastq_vstream_open.argtypes = [u8p, ctypes.c_int64]
        lib.stpu_fastq_vstream_next_packed.restype = ctypes.c_int64
        lib.stpu_fastq_vstream_next_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, u8p, u8p, i32p,
            ctypes.c_int64, ctypes.c_int64]
        lib.stpu_fastq_vstream_status.restype = ctypes.c_int
        lib.stpu_fastq_vstream_status.argtypes = [ctypes.c_void_p]
        lib.stpu_fastq_vstream_nrec.restype = ctypes.c_int64
        lib.stpu_fastq_vstream_nrec.argtypes = [ctypes.c_void_p]
        lib.stpu_fastq_vstream_maxlen.restype = ctypes.c_int64
        lib.stpu_fastq_vstream_maxlen.argtypes = [ctypes.c_void_p]
        lib.stpu_fastq_vstream_ranges.restype = ctypes.c_int
        lib.stpu_fastq_vstream_ranges.argtypes = [ctypes.c_void_p]
        lib.stpu_fastq_vstream_close.restype = None
        lib.stpu_fastq_vstream_close.argtypes = [ctypes.c_void_p]
        lib.stpu_build_stage1.restype = ctypes.c_void_p
        lib.stpu_build_stage1.argtypes = [
            u8p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64, i64p]
        lib.stpu_build_stage2.restype = ctypes.c_int64
        lib.stpu_build_stage2.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32), i64p, i64p,
            i32p, i64p, i32p]
        lib.stpu_build_fetch_sets.restype = None
        lib.stpu_build_fetch_sets.argtypes = [ctypes.c_void_p, u8p, i32p]
        lib.stpu_build_free.restype = None
        lib.stpu_build_free.argtypes = [ctypes.c_void_p]
        lib.stpu_fastq_ids.restype = ctypes.c_int64
        lib.stpu_fastq_ids.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, i64p, u8p]
        lib.stpu_pack2.restype = ctypes.c_int64
        lib.stpu_pack2.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, u8p, i32p,
            ctypes.c_int64, ctypes.c_int64]
        _lib = lib
    except Exception:
        _lib_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def _as_u8(buf: bytes) -> Tuple[ctypes.POINTER(ctypes.c_uint8), int]:
    arr = np.frombuffer(buf, dtype=np.uint8)
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


_PAGE = 4096
_MADV_HUGEPAGE = 14
_libc = None


def _advise_hugepages(*arrays: np.ndarray) -> None:
    """MADV_HUGEPAGE the page-aligned span of each big fresh buffer.

    This host faults 4K pages at ~0.08 GB/s but hugepage-advised spans at
    ~1.8 GB/s (measured); large np.empty buffers that are about to be
    written once (the native fetch targets) gain ~20x on first touch.
    Best-effort: any failure leaves the buffer as-is."""
    global _libc
    try:
        if _libc is None:
            _libc = ctypes.CDLL(None, use_errno=True)
        for a in arrays:
            if a.nbytes < (1 << 20):
                continue
            start = a.ctypes.data
            end = start + a.nbytes
            astart = (start + _PAGE - 1) & ~(_PAGE - 1)
            aend = end & ~(_PAGE - 1)
            if aend > astart:
                _libc.madvise(ctypes.c_void_p(astart),
                              ctypes.c_size_t(aend - astart),
                              ctypes.c_int(_MADV_HUGEPAGE))
    except Exception:
        pass


class LmaxExceeded(Exception):
    """A record in the stream is longer than the caller's row stride
    (possible in lazy-scan mode, where the stride is a first-record
    guess); the caller restarts with a larger stride."""


class NativeParseError(Exception):
    def __init__(self, status: int, err_index: int, err_aux: int) -> None:
        super().__init__(f"native parse status {status}")
        self.status = status
        self.err_index = err_index
        self.err_aux = err_aux


def fastq_parse(data: bytes):
    """Returns (codes [N, Lmax] u8, qual [N, Lmax] u8, lengths [N] i32,
    ids list[str], space_len [N] i32) or raises NativeParseError / returns
    None if the lib is unavailable or input is non-ASCII (caller falls
    back)."""
    lib = _load()
    if lib is None:
        return None
    p, n = _as_u8(data)
    info = np.zeros(8, dtype=np.int64)
    status = lib.stpu_fastq_scan(p, n, _ptr(info, ctypes.c_int64))
    if status == STATUS_NON_ASCII:
        return None
    if status != STATUS_OK:
        raise NativeParseError(status, int(info[3]), int(info[4]))
    n_rec, lmax, idb = int(info[0]), int(info[1]), int(info[2])
    lmax = max(lmax, 1)
    codes = np.zeros((n_rec, lmax), dtype=np.uint8)
    qual = np.zeros((n_rec, lmax), dtype=np.uint8)
    lengths = np.zeros(n_rec, dtype=np.int32)
    id_offsets = np.zeros(n_rec + 1, dtype=np.int64)
    id_buf = np.zeros(max(idb, 1), dtype=np.uint8)
    space_len = np.zeros(n_rec, dtype=np.int32)
    lib.stpu_fastq_fill(
        p, n, _ptr(codes, ctypes.c_uint8), _ptr(qual, ctypes.c_uint8),
        _ptr(lengths, ctypes.c_int32), lmax,
        _ptr(id_offsets, ctypes.c_int64), _ptr(id_buf, ctypes.c_uint8),
        _ptr(space_len, ctypes.c_int32),
    )
    # one decode pass + string slicing: a per-record bytes-slice+decode
    # costs ~2x (ids are ~40% of the 512k-read parse time)
    blob = id_buf.tobytes().decode("ascii")
    offs = id_offsets.tolist()
    ids = [blob[offs[i]: offs[i + 1]] for i in range(n_rec)]
    return codes, qual, lengths, ids, space_len


class FastqScanInfo:
    """Sizing/validation result of a whole-file native FASTQ scan."""

    __slots__ = ("n_records", "max_len")

    def __init__(self, n_records: int, max_len: int) -> None:
        self.n_records = n_records
        self.max_len = max_len


def fastq_scan(data: bytes) -> Optional[FastqScanInfo]:
    """Validate + size the whole input without filling arrays.

    Enforces the same contracts as the full parse (duplicate ids, unparsed
    data, seq/quality length mismatch).  Returns None when the native lib
    is unavailable or the input is non-ASCII (caller falls back to the
    regex engine)."""
    lib = _load()
    if lib is None:
        return None
    p, n = _as_u8(data)
    info = np.zeros(8, dtype=np.int64)
    status = lib.stpu_fastq_scan(p, n, _ptr(info, ctypes.c_int64))
    if status == STATUS_NON_ASCII:
        return None
    if status != STATUS_OK:
        raise NativeParseError(status, int(info[3]), int(info[4]))
    return FastqScanInfo(int(info[0]), max(int(info[1]), 1))


#: the validating fill's thread cap (``shotgun_io.cpp kMaxThreads``)
MAX_FILL_THREADS = 8
FILL_THREADS_ENV = "SHOTGUN_TPU_FILL_THREADS"


def fill_threads() -> int:
    """Threads of the validating fill: ``SHOTGUN_TPU_FILL_THREADS`` when it
    holds a whole number, else the cores this process may use less one for
    the stream's consumer, at most ``MAX_FILL_THREADS``."""
    try:
        return int(os.environ[FILL_THREADS_ENV])
    except (KeyError, ValueError):
        return max(1, min(MAX_FILL_THREADS, len(os.sched_getaffinity(0)) - 1))


def fastq_stream_chunks_vpacked(data: bytes, chunk_records: int, lmax: int,
                                with_qual: bool, n_threads: Optional[int] = None):
    """Yield (codes [C, lmax/4] u8, qual, lengths [C] i32, n_filled)
    chunks of a FASTQ buffer, validating it as they fill.  Codes arrive
    2-bit packed (the device-unpack layout of
    ops.encode.unpack_codes_2bit) and the quality plane [C, lmax] is
    filled only when ``with_qual`` (otherwise a shared zero [C, 1] dummy
    is yielded); lmax must be a multiple of 4 and fresh zeroed arrays
    are allocated per chunk, so padding is zero as the device quality
    gates need.  The native fill enforces the whole-input contract
    itself (structure, character classes, duplicate ids, length
    equality, unparsed data) while packing, on ``n_threads`` threads
    (default ``fill_threads()``): a chunk of 4,096 records or more has
    its structure walk split into byte ranges and its encode into rows,
    with the serial walk's output -- no separate whole-input scan pass
    needed.  Raises NativeParseError
    on invalid input (statuses advisory: the caller reruns through the
    regex engine for the reference's exact errors) and LmaxExceeded when
    a record exceeds the stride.  The final yield is followed by an
    end-of-stream status check (catches empty inputs).  With the
    registry on, each chunk counts into ``fill_walk_split`` or
    ``fill_walk_serial`` by how its walk ran, with its records."""
    lib = _load()
    assert lib is not None, "requires the native lib"
    assert lmax % 4 == 0
    if n_threads is None:
        n_threads = fill_threads()
    p, n = _as_u8(data)
    handle = lib.stpu_fastq_vstream_open(p, n)
    assert handle
    null_u8 = ctypes.POINTER(ctypes.c_uint8)()
    dummy = np.zeros((chunk_records, 1), dtype=np.uint8)
    try:
        while True:
            with phase("fill"):
                codes = np.zeros((chunk_records, lmax // 4), dtype=np.uint8)
                qual = (np.zeros((chunk_records, lmax), dtype=np.uint8)
                        if with_qual else dummy)
                lengths = np.zeros(chunk_records, dtype=np.int32)
                got = lib.stpu_fastq_vstream_next_packed(
                    handle, chunk_records,
                    _ptr(codes, ctypes.c_uint8),
                    _ptr(qual, ctypes.c_uint8) if with_qual else null_u8,
                    _ptr(lengths, ctypes.c_int32), lmax, n_threads,
                )
            if got > 0 and PROFILER.enabled:
                split = lib.stpu_fastq_vstream_ranges(handle) > 1
                PROFILER.count("fill_walk_split" if split else "fill_walk_serial", got)
            if got == -1:
                raise LmaxExceeded(lmax)
            if got == -2 or got == 0:
                status = int(lib.stpu_fastq_vstream_status(handle))
                if status != STATUS_OK:
                    raise NativeParseError(status, 0, 0)
                return
            yield codes, qual, lengths, int(got)
    finally:
        lib.stpu_fastq_vstream_close(handle)
        # let go of the input at once, not with a traceback that still
        # holds this frame: a mapped input closes only once unexported
        del p


def build_kmer_index(codes: np.ndarray, offsets: np.ndarray, k: int):
    """Native k-mer index assembly (k <= 31): rolling encode + stable
    multithreaded radix sort + CSR/set-table build in C++
    (io/csrc/kmer_build.cpp).

    Returns a dict of KmerIndex array fields or None when the native lib
    is unavailable or the input is outside the fast path's domain (the
    caller falls back to the numpy assembly in index/build.py, which
    handles any k)."""
    lib = _load()
    if lib is None or k < 1 or k > 31:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n_records = offsets.size - 1
    sizes = np.zeros(8, dtype=np.int64)
    handle = lib.stpu_build_stage1(
        _ptr(codes, ctypes.c_uint8), codes.size,
        _ptr(offsets, ctypes.c_int64), n_records, k,
        _ptr(sizes, ctypes.c_int64),
    )
    if not handle:
        return None
    try:
        u, p, gbytes = int(sizes[0]), int(sizes[1]), int(sizes[2])
        # np.empty: stage 2 writes every element directly into these
        # buffers (no intermediate C++ copy -- see kmer_build.cpp)
        kmer_words = np.empty((u, 2), dtype=np.uint32)
        first_seen = np.empty(u, dtype=np.int64)
        post_offsets = np.empty(u + 1, dtype=np.int64)
        post_record = np.empty(p, dtype=np.int32)
        post_pos = np.empty(p, dtype=np.int64)
        set_id = np.empty(u, dtype=np.int32)
        _advise_hugepages(kmer_words, first_seen, post_offsets,
                          post_record, post_pos, set_id)
        s = int(lib.stpu_build_stage2(
            handle,
            _ptr(kmer_words, ctypes.c_uint32),
            _ptr(first_seen, ctypes.c_int64),
            _ptr(post_offsets, ctypes.c_int64),
            _ptr(post_record, ctypes.c_int32),
            _ptr(post_pos, ctypes.c_int64),
            _ptr(set_id, ctypes.c_int32),
        ))
        set_masks = np.empty((s, gbytes), dtype=np.uint8)
        set_sizes = np.empty(s, dtype=np.int32)
        lib.stpu_build_fetch_sets(
            handle, _ptr(set_masks, ctypes.c_uint8),
            _ptr(set_sizes, ctypes.c_int32))
    finally:
        lib.stpu_build_free(handle)
    return {
        "kmer_words": kmer_words,
        "first_seen": first_seen,
        "post_offsets": post_offsets,
        "post_record": post_record,
        "post_pos": post_pos,
        "set_id": set_id,
        "set_masks": set_masks,
        "set_sizes": set_sizes,
    }


def fasta_parse(data: bytes):
    """Returns (codes concat u8, seq_offsets [N+1] i64, descriptions
    list[str]) or None for fallback."""
    lib = _load()
    if lib is None:
        return None
    p, n = _as_u8(data)
    info = np.zeros(8, dtype=np.int64)
    status = lib.stpu_fasta_scan(p, n, _ptr(info, ctypes.c_int64))
    if status == STATUS_NON_ASCII:
        return None
    if status != STATUS_OK:
        raise NativeParseError(status, int(info[3]), int(info[4]))
    n_rec, total_bases, db = int(info[0]), int(info[1]), int(info[2])
    codes = np.zeros(max(total_bases, 1), dtype=np.uint8)
    seq_offsets = np.zeros(n_rec + 1, dtype=np.int64)
    desc_offsets = np.zeros(n_rec + 1, dtype=np.int64)
    desc_buf = np.zeros(max(db, 1), dtype=np.uint8)
    lib.stpu_fasta_fill(
        p, n, _ptr(codes, ctypes.c_uint8), _ptr(seq_offsets, ctypes.c_int64),
        _ptr(desc_offsets, ctypes.c_int64), _ptr(desc_buf, ctypes.c_uint8),
    )
    blob = desc_buf.tobytes()
    descriptions = [
        blob[desc_offsets[i]: desc_offsets[i + 1]].decode("ascii")
        for i in range(n_rec)
    ]
    return codes[:total_bases], seq_offsets, descriptions


def pack2(codes: np.ndarray, gp: int, codes2_out: np.ndarray,
          runs_out: np.ndarray) -> Optional[int]:
    """2-bit pack of a code plane directly into a caller buffer plus a
    sparse (start, end) N-run list (the device-build upload;
    io/csrc/kmer_build.cpp stpu_pack2).  Returns the run count, -1 when
    the runs exceed the buffer (caller falls back to the host builder),
    or None when the lib is missing (caller packs with numpy)."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    return int(lib.stpu_pack2(
        _ptr(codes, ctypes.c_uint8), codes.size, gp,
        _ptr(codes2_out, ctypes.c_uint8), _ptr(runs_out, ctypes.c_int32),
        runs_out.size // 2, 2,
    ))


def fastq_ids(data: bytes, n_records: int):
    """Identifier strings (the reference's unique first-section data,
    records.py:256) of a SCAN-VALIDATED FASTQ byte buffer, in file
    order (the streamed align-task path extracts ids separately from the
    packed fill; io/csrc/shotgun_io.cpp stpu_fastq_ids).  None when the
    lib is unavailable or the walk disagrees with the expected record
    count (caller falls back to the full parse)."""
    lib = _load()
    if lib is None:
        return None
    p, n = _as_u8(data)
    id_offsets = np.zeros(n_records + 1, dtype=np.int64)
    id_buf = np.empty(max(n, 1), dtype=np.uint8)
    got = int(lib.stpu_fastq_ids(
        p, n, n_records, _ptr(id_offsets, ctypes.c_int64),
        _ptr(id_buf, ctypes.c_uint8)))
    if got != n_records:
        return None
    blob = id_buf[: id_offsets[n_records]].tobytes().decode("ascii")
    offs = id_offsets.tolist()
    return [blob[offs[i]: offs[i + 1]] for i in range(n_records)]
