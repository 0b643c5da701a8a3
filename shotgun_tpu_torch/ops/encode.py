"""Numeric k-mer encoding (counterpart of ``shotgun_tpu/ops/encode.py``).

A k-mer (k <= 31) is one int64 key per window, ``hi << 32 | lo`` of the
JAX package's (lo, hi) uint32 pair (``hi < 2**30``).  The table hash is
the same two-word xorshift-multiply ``mix32``; host table build and
device probe must agree bit for bit, so it has a numpy form (build) and a
torch form (the plain probe).

PyTorch on the CPU has no ``<<``, ``>>`` or ``min`` for ``uint32``, so
the torch forms work in int64 and keep the low 32 bits with
``& 0xFFFFFFFF`` after every multiply (an int64 product may wrap; only
its low 32 bits are kept, and those are exact).

Kernel H1 ``encode_window`` (``ops/kernels/csrc/encode_window.cu``)
fuses the 2-bit unpack, the rolling encode and the window quality sums at
k <= 31; kernel H3 ``encode_words`` (``ops/kernels/csrc/encode_words.cu``)
does the same for the multi-word keys of k >= 32.  ``encode_window`` and
``encode_words`` below are their wrappers: a CUDA tensor launches the
kernel (or raises); a CPU tensor takes ``encode_window_plain`` or
``encode_words_plain``.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from shotgun_tpu_torch.ops.kernels.build import check_status, load_library

# splitmix64-derived odd constants (shotgun_tpu/ops/encode.py:63-67)
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_C3 = 0x27D4EB2F
_GOLDEN = 0x9E3779B9
M32 = 0xFFFFFFFF
MAX_K = 31
#: positions kernel H1 stages a block (``kSpan`` of encode_window.cu); a
#: block owns the windows that start in the first ``H1_SPAN - 64`` of them
H1_SPAN = 4096


def mix32_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Hash uint32 (lo, hi) arrays to the uint32 bucket basis (host form)."""
    u = np.uint32
    h = (lo ^ u(_GOLDEN)) * u(_C1)
    h = h ^ (h >> u(15))
    h = (h ^ (hi * u(_C2))) * u(_C3)
    h = h ^ (h >> u(13))
    h = h * u(_C1)
    h = h ^ (h >> u(16))
    return h


def mix32(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``mix32_np`` on int64 tensors holding uint32 values -> int64 in
    [0, 2**32)."""
    h = ((lo ^ _GOLDEN) * _C1) & M32
    h = h ^ (h >> 15)
    h = ((h ^ ((hi * _C2) & M32)) * _C3) & M32
    h = h ^ (h >> 13)
    h = (h * _C1) & M32
    return h ^ (h >> 16)


def split_key(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 keys -> (lo, hi) int64 tensors of the two uint32 words."""
    return keys & M32, keys >> 32


def unpack_codes_2bit(packed: torch.Tensor) -> torch.Tensor:
    """[B, L/4] uint8 (4 bases a byte, base i in bits 2*(i%4)) ->
    [B, L] uint8 base codes."""
    b, p = packed.shape
    shifts = torch.arange(4, device=packed.device, dtype=torch.int32) * 2
    codes = (packed.to(torch.int32)[:, :, None] >> shifts) & 3
    return codes.to(torch.uint8).reshape(b, 4 * p)


def pack_codes_2bit(codes: np.ndarray) -> np.ndarray:
    """Host-side inverse of ``unpack_codes_2bit`` ([B, L] u8, L % 4 == 0)."""
    c = codes.reshape(codes.shape[0], -1, 4)
    return (c[:, :, 0] | (c[:, :, 1] << 2)
            | (c[:, :, 2] << 4) | (c[:, :, 3] << 6))


def rolling_encode_plain(codes: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L] uint8 base codes -> [B, W] int64 keys, W = L - k + 1.

    The k-step shift recurrence of ``rolling_encode_jnp``; starting from
    zero, k steps leave exactly the window's 2k bits."""
    b, l = codes.shape
    w = l - k + 1
    if w < 1:
        raise ValueError(f"batch length {l} must be >= k={k}")
    c = codes.to(torch.int64) & 3
    key = torch.zeros((b, w), dtype=torch.int64, device=codes.device)
    for j in range(k):
        key = (key << 2) | c[:, j: j + w]
    return key


def window_quality_sums_plain(qual: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L] uint8 raw quality bytes -> [B, W] int32 window sums."""
    b, l = qual.shape
    w = l - k + 1
    cs = torch.cumsum(qual.to(torch.int32), dim=1, dtype=torch.int32)
    cs = torch.cat(
        [torch.zeros((b, 1), dtype=torch.int32, device=qual.device), cs], dim=1)
    return cs[:, k: k + w] - cs[:, 0:w]


def encode_window_plain(
    packed: Optional[torch.Tensor], k: int, qual: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain PyTorch version of kernel H1: (keys int64 [B, W] or None,
    qsums int32 [B, W] or None)."""
    keys = (rolling_encode_plain(unpack_codes_2bit(packed), k)
            if packed is not None else None)
    qsums = window_quality_sums_plain(qual, k) if qual is not None else None
    return keys, qsums


def _check_u8_2d(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.uint8 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous 2-D uint8 tensor, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")


def encode_window(
    packed: Optional[torch.Tensor], k: int, qual: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Kernel H1: packed codes [B, L/4] u8 and/or qual [B, L] u8 ->
    (keys int64 [B, W], qsums int32 [B, W]), W = L - k + 1; an output is
    None when its input is.

    A CUDA tensor launches the kernel on the current stream (counted in
    ``encode_window.launches``, one per launch whatever it computes, and
    in ``encode_window.launches_by_mode`` under "keys", "sums" or
    "keys+sums", with ", one row" for a single row such as the device
    build's genome); a CPU tensor takes ``encode_window_plain``."""
    given = [x for x in (packed, qual) if x is not None]
    if not given:
        raise ValueError("encode_window needs packed codes or qual")
    device = given[0].device
    if any(x.device != device for x in given):
        raise ValueError("packed and qual must be on one device")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"encode_window supports 1 <= k <= {MAX_K}, got {k}")
    for x, name in ((packed, "packed"), (qual, "qual")):
        if x is not None:
            _check_u8_2d(x, name)
    rows = given[0].shape[0]
    length = packed.shape[1] * 4 if packed is not None else qual.shape[1]
    if qual is not None and tuple(qual.shape) != (rows, length):
        raise ValueError(
            f"qual shape {tuple(qual.shape)} != ({rows}, {length}) of the codes")
    if length < k:
        raise ValueError(f"batch length {length} must be >= k={k}")
    if device.type == "cpu":
        return encode_window_plain(packed, k, qual)
    if device.type != "cuda":
        raise ValueError(f"encode_window: unsupported device {device}")

    w = length - k + 1
    keys = (torch.empty((rows, w), dtype=torch.int64, device=device)
            if packed is not None else None)
    qsums = (torch.empty((rows, w), dtype=torch.int32, device=device)
             if qual is not None else None)
    lib = load_library()
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    # the launch sets the device; the guard gives the caller's back
    with torch.cuda.device(device):
        status = lib.stt_encode_window(
            ptr(packed), ptr(qual), ptr(keys), ptr(qsums), rows, length, k,
            device.index, torch.cuda.current_stream(device).cuda_stream)
    check_status(lib, status, "encode_window")
    encode_window.launches += 1
    mode = "keys+sums" if keys is not None and qsums is not None else (
        "keys" if keys is not None else "sums")
    encode_window.launches_by_mode[mode + ", one row" * (rows == 1)] += 1
    return keys, qsums


encode_window.launches = 0
encode_window.launches_by_mode = Counter()


def rolling_encode(packed: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L/4] packed codes -> [B, W] int64 keys (kernel H1 on CUDA)."""
    return encode_window(packed, k)[0]


# --- multi-word keys, any k (the JAX package's rolling_encode_words_jnp) -----
#
# A k-mer of any k is ceil(k / 31) int64 words, most significant first: full
# word j holds bases [31j, 31j + 31) of the window, and a tail word the last
# k mod 31 bases when there are any.  Each word is a base-4 number of at most
# 62 bits, so comparing the word tuples lexicographically is comparing the
# k-mers (and their 2k-bit keys).  At k <= 31 the one word is H1's key; at
# k >= 32 kernel H3 ``encode_words`` (``ops/kernels/csrc/encode_words.cu``)
# writes every word and the window sums in one launch.

#: bases in a word of a multi-word key
WORD_BASES = MAX_K
#: positions of kernel H3's quality prefixes (``kSpan`` of encode_words.cu);
#: a block owns the windows that start in the first ``H3_SPAN - 128``
H3_SPAN = 4096


def word_spans(k: int) -> list:
    """[(first base, bases)] of each word of a k-mer, most significant
    first."""
    spans = [(s, WORD_BASES) for s in range(0, k - WORD_BASES + 1, WORD_BASES)]
    if k % WORD_BASES:
        spans.append((k - k % WORD_BASES, k % WORD_BASES))
    return spans


def encode_words_plain(
    packed: torch.Tensor, k: int, qual: Optional[torch.Tensor] = None,
) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
    """Plain PyTorch version of ``encode_words``: each word rolled from
    the unpacked codes, the sums from a cumulative sum at k."""
    codes = unpack_codes_2bit(packed)
    w = codes.shape[1] - k + 1
    words = tuple(rolling_encode_plain(codes[:, s: s + n + w - 1], n)
                  for s, n in word_spans(k))
    qsums = window_quality_sums_plain(qual, k) if qual is not None else None
    return words, qsums


def encode_words(
    packed: torch.Tensor, k: int, qual: Optional[torch.Tensor] = None,
) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
    """Multi-word window keys of any k >= 1: packed codes [B, L/4] u8 and
    optionally qual [B, L] u8 -> (ceil(k / 31) int64 [B, W] words, most
    significant first, each contiguous; qsums int32 [B, W] or None),
    W = L - k + 1.

    A CUDA tensor at k <= 31 takes H1 ``encode_window`` (one launch, its
    key the one word); at k >= 32 it launches kernel H3 on the current
    stream, once (counted in ``encode_words.launches``, and in
    ``encode_words.launches_by_mode`` under "k=<k>, keys" or
    "k=<k>, keys+sums", with ", one row" for a single row such as the
    device build's genome), whose
    words are planes of one [ceil(k / 31), B, W] tensor.  A CPU tensor
    takes ``encode_words_plain``."""
    if k < 1:
        raise ValueError(f"encode_words supports k >= 1, got {k}")
    _check_u8_2d(packed, "packed")
    rows, length = packed.shape[0], packed.shape[1] * 4
    if length < k:
        raise ValueError(f"batch length {length} must be >= k={k}")
    device = packed.device
    if qual is not None and qual.device != device:
        raise ValueError("packed and qual must be on one device")
    if device.type == "cpu":
        return encode_words_plain(packed, k, qual)
    if k <= MAX_K:
        keys, qsums = encode_window(packed, k, qual)
        return (keys,), qsums
    if device.type != "cuda":
        raise ValueError(f"encode_words: unsupported device {device}")
    if qual is not None:
        _check_u8_2d(qual, "qual")
        if tuple(qual.shape) != (rows, length):
            raise ValueError(
                f"qual shape {tuple(qual.shape)} != ({rows}, {length}) of the codes")

    w = length - k + 1
    planes = torch.empty((len(word_spans(k)), rows, w), dtype=torch.int64, device=device)
    qsums = (torch.empty((rows, w), dtype=torch.int32, device=device)
             if qual is not None else None)
    lib = load_library()
    # the launch sets the device; the guard gives the caller's back
    with torch.cuda.device(device):
        status = lib.stt_encode_words(
            packed.data_ptr(), qual.data_ptr() if qual is not None else None,
            planes.data_ptr(), qsums.data_ptr() if qsums is not None else None,
            rows, length, k, device.index, torch.cuda.current_stream(device).cuda_stream)
    check_status(lib, status, "encode_words")
    encode_words.launches += 1
    encode_words.launches_by_mode[f"k={k}, " + ("keys+sums" if qual is not None
                                                 else "keys")
                                  + ", one row" * (rows == 1)] += 1
    return tuple(planes.unbind(0)), qsums


encode_words.launches = 0
encode_words.launches_by_mode = Counter()


def window_quality_sums(qual: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L] uint8 quality -> [B, W] int32 window sums (kernel H1 on CUDA)."""
    return encode_window(None, k, qual)[1]
