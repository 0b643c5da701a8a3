"""shotgun_tpu_torch.ops.encode (kernel H1's plain path) against the JAX
package's encode: its jnp forms and its Pallas kernels in interpret mode.
Every output is an integer and compared exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from shotgun_tpu.ops import encode as jenc
from shotgun_tpu.ops.pallas.kernels import (
    rolling_encode_pallas,
    window_qsums_pallas,
)
from shotgun_tpu_torch.ops import encode as tenc
from shotgun_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)


def _padded(rng, b, l, lo, hi, dtype=np.uint8):
    """Random [b, l] rows with random lengths; positions past each row's
    length are 0, as the native fill pads them."""
    x = rng.integers(lo, hi, size=(b, l), dtype=dtype)
    lengths = rng.integers(l // 2, l + 1, size=b)
    x[np.arange(l)[None, :] >= lengths[:, None]] = 0
    return x


def _key64(lo, hi) -> np.ndarray:
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64)).astype(np.int64)


def test_mix32_matches_all_forms():
    rng = np.random.default_rng(1)
    lo = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    want = jenc.mix32(lo, hi, np)
    np.testing.assert_array_equal(tenc.mix32_np(lo, hi), want)
    np.testing.assert_array_equal(
        np.asarray(jenc.mix32(jnp.asarray(lo), jnp.asarray(hi), jnp)), want)
    got = tenc.mix32(torch.from_numpy(lo.astype(np.int64)),
                     torch.from_numpy(hi.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_unpack_and_pack_codes_2bit():
    rng = np.random.default_rng(2)
    packed = rng.integers(0, 256, size=(16, 40), dtype=np.uint8)
    want = np.asarray(jenc.unpack_codes_2bit(jnp.asarray(packed)))
    got = tenc.unpack_codes_2bit(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tenc.pack_codes_2bit(want),
                                  jenc.pack_codes_2bit(want))
    np.testing.assert_array_equal(tenc.pack_codes_2bit(want), packed)


@pytest.mark.parametrize("b,l,k", [(32, 60, 7), (24, 64, 11), (16, 160, 31),
                                   (8, 40, 31)])
def test_rolling_encode_matches_jnp_and_pallas(b, l, k):
    rng = np.random.default_rng(b * 100 + k)
    codes = _padded(rng, b, l, 0, 4)
    lo, hi = jenc.rolling_encode_jnp(jnp.asarray(codes), k)
    want = _key64(lo, hi)
    lo_p, hi_p = rolling_encode_pallas(jnp.asarray(codes), k, interpret=True)
    np.testing.assert_array_equal(_key64(lo_p, hi_p), want)

    packed = torch.from_numpy(tenc.pack_codes_2bit(codes))
    np.testing.assert_array_equal(tenc.rolling_encode(packed, k).numpy(), want)
    np.testing.assert_array_equal(
        tenc.rolling_encode_plain(torch.from_numpy(codes), k).numpy(), want)
    assert (want >> 62 == 0).all()  # hi < 2**30


@pytest.mark.parametrize("b,l,k", [(32, 60, 11), (16, 160, 31), (8, 40, 7)])
def test_window_quality_sums_matches_jnp_and_pallas(b, l, k):
    rng = np.random.default_rng(b * k)
    qual = _padded(rng, b, l, 33, 127)
    want = np.asarray(jenc.window_quality_sums(jnp.asarray(qual), k))
    np.testing.assert_array_equal(
        np.asarray(window_qsums_pallas(jnp.asarray(qual), k, interpret=True)),
        want)
    got = tenc.window_quality_sums(torch.from_numpy(qual), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_window_fused_on_cpu_takes_plain_and_counts_nothing():
    rng = np.random.default_rng(5)
    codes = _padded(rng, 12, 64, 0, 4)
    qual = _padded(rng, 12, 64, 33, 127)
    packed = torch.from_numpy(tenc.pack_codes_2bit(codes))
    before = tenc.encode_window.launches
    keys, qsums = tenc.encode_window(packed, 21, torch.from_numpy(qual))
    assert tenc.encode_window.launches == before
    lo, hi = jenc.rolling_encode_jnp(jnp.asarray(codes), 21)
    np.testing.assert_array_equal(keys.numpy(), _key64(lo, hi))
    np.testing.assert_array_equal(
        qsums.numpy(), np.asarray(jenc.window_quality_sums(jnp.asarray(qual), 21)))
    assert tenc.encode_window(packed, 21)[1] is None


@pytest.mark.parametrize("bad", ["dtype", "k", "qual_shape", "short"])
def test_encode_window_rejects_bad_input(bad):
    packed = torch.zeros((4, 8), dtype=torch.uint8)
    qual = torch.zeros((4, 32), dtype=torch.uint8)
    k = 11
    if bad == "dtype":
        packed = packed.to(torch.int32)
    elif bad == "k":
        k = 32
    elif bad == "qual_shape":
        qual = torch.zeros((4, 30), dtype=torch.uint8)
    else:
        packed = torch.zeros((4, 2), dtype=torch.uint8)
        qual = None
    with pytest.raises(ValueError):
        tenc.encode_window(packed, k, qual)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


# --- a numpy model of kernel H1's arithmetic (ops/kernels/csrc/encode_window.cu):
# tiles of positions with their halo, the funnel extract of two 64-bit words
# turned around by a bit reverse and a pair swap, and the window sums from a
# tile's prefix sum.  Its index math is the kernel's, line for line.

_U64 = np.uint64
_M1 = _U64(0x5555555555555555)


def _brev64(x: np.ndarray) -> np.ndarray:
    """Bit reverse of uint64 values (``__brevll``)."""
    for shift, mask in ((1, 0x5555555555555555), (2, 0x3333333333333333),
                        (4, 0x0F0F0F0F0F0F0F0F), (8, 0x00FF00FF00FF00FF),
                        (16, 0x0000FFFF0000FFFF)):
        s, m = _U64(shift), _U64(mask)
        x = ((x >> s) & m) | ((x & m) << s)
    return (x >> _U64(32)) | (x << _U64(32))


def _model_window_key(words: np.ndarray, f: np.ndarray, k: int) -> np.ndarray:
    lo, hi = words[f >> 5], words[(f >> 5) + 1]
    s = (2 * (f & 31)).astype(_U64)
    x = (lo >> s) | ((hi << _U64(1)) << (_U64(63) - s))
    r = _brev64(x)
    r = ((r >> _U64(1)) & _M1) | ((r & _M1) << _U64(1))
    return (r >> _U64(64 - 2 * k)).astype(np.int64)


def encode_window_model(packed, qual, k, span=tenc.H1_SPAN):
    """(keys, qsums) of kernel H1 as its blocks compute them: each block
    owns the windows starting in ``span - 64`` positions of the flattened
    batch and stages ``span`` positions, zero past the end."""
    data = packed if packed is not None else qual
    rows = data.shape[0]
    length = packed.shape[1] * 4 if packed is not None else qual.shape[1]
    tile = span - 64
    total, nwin = rows * length, length - k + 1
    flat_p = packed.reshape(-1) if packed is not None else None
    flat_q = qual.reshape(-1).astype(np.int32) if qual is not None else None
    keys = np.full(rows * nwin, -1, np.int64) if packed is not None else None
    qsums = np.full(rows * nwin, -1, np.int32) if qual is not None else None
    for f0 in range(0, total, tile):
        f1 = min(f0 + tile, total)
        b0, r0 = divmod(f0, length)
        b1, r1 = divmod(f1, length)
        g0 = b0 * nwin + min(r0, nwin)
        n_out = b1 * nwin + min(r1, nwin) - g0
        first = 0 if r0 < nwin else length - r0
        w_first = r0 if r0 < nwin else 0
        t = np.arange(n_out)
        if nwin < tile:
            ends = (w_first + t) // nwin
        else:
            ends = (t >= min(nwin - w_first, tile)).astype(np.int64)
        f = first + t + ends * (k - 1)
        assert f.size == 0 or (f.max() < tile and f.max() + k <= span)
        if packed is not None:
            staged = np.zeros(span // 4 + 8, np.uint8)
            part = flat_p[f0 // 4: (f0 + span) // 4]
            staged[: part.size] = part
            words = staged[: span // 4].view("<u8")
            keys[g0: g0 + n_out] = _model_window_key(words, f, k)
        if qual is not None:
            staged = np.zeros(span, np.int32)
            part = flat_q[f0: f0 + span]
            staged[: part.size] = part
            prefix = np.concatenate([[0], np.cumsum(staged, dtype=np.int32)])
            qsums[g0: g0 + n_out] = prefix[f + k] - prefix[f]
    shape = (rows, nwin)
    return (keys.reshape(shape) if keys is not None else None,
            qsums.reshape(shape) if qsums is not None else None)


#: (rows, packed row bytes, span): whole rows many to a tile, rows longer
#: than a tile, a ragged last tile, and the kernel's own span
MODEL_SHAPES = [(9, 10, 256), (3, 130, 256), (1, 257, 256), (2, 41, 4096),
                (5, 8, 128)]


@pytest.mark.parametrize("k", range(1, 32))
def test_h1_model_equals_plain_and_jax(k):
    """The kernel's arithmetic (numpy model) against ``encode_window_plain``
    at every k, on shapes that cut rows and windows at tile edges, with
    windows that reach into the zero padding; and against the JAX jnp
    forms at the kernel's span."""
    rng = np.random.default_rng(1000 + k)
    for rows, width, span in MODEL_SHAPES:
        length = 4 * width
        if length < k:
            continue
        codes = _padded(rng, rows, length, 0, 4)
        qual = _padded(rng, rows, length, 33, 127)
        packed = tenc.pack_codes_2bit(codes)
        keys, qsums = encode_window_model(packed, qual, k, span)
        want_k, want_q = tenc.encode_window_plain(
            torch.from_numpy(packed), k, torch.from_numpy(qual))
        np.testing.assert_array_equal(keys, want_k.numpy())
        np.testing.assert_array_equal(qsums, want_q.numpy())
        if span == tenc.H1_SPAN:  # one JAX compile a k
            lo, hi = jenc.rolling_encode_jnp(jnp.asarray(codes), k)
            np.testing.assert_array_equal(keys, _key64(lo, hi))
            np.testing.assert_array_equal(
                qsums, np.asarray(jenc.window_quality_sums(jnp.asarray(qual), k)))
        only_keys, none = encode_window_model(packed, None, k, span)
        assert none is None
        np.testing.assert_array_equal(only_keys, keys)


@pytest.mark.parametrize("k", [1, 2, 15, 31])
def test_h1_model_equals_pallas_at_the_kernel_span(k):
    """At the kernel's own span, a single row one tile plus a window long
    and a batch of 40-byte rows: the model equals the JAX Pallas kernels
    in interpret mode."""
    rng = np.random.default_rng(k)
    for rows, length in ((1, tenc.H1_SPAN - 64 + k + 3 - (k + 3) % 4), (7, 160)):
        codes = _padded(rng, rows, length, 0, 4)
        qual = _padded(rng, rows, length, 33, 127)
        keys, qsums = encode_window_model(tenc.pack_codes_2bit(codes), qual, k)
        assert keys.shape[1] == length - k + 1
        lo, hi = rolling_encode_pallas(jnp.asarray(codes), k, interpret=True)
        np.testing.assert_array_equal(keys, _key64(lo, hi))
        np.testing.assert_array_equal(
            qsums, np.asarray(window_qsums_pallas(jnp.asarray(qual), k, interpret=True)))


# --- multi-word keys (k > 31): the port's 31-base words against the JAX
# package's 16-base words, each compared as the full key (a Python int)

WORD_KS = [32, 35, 62, 63, 64, 75, 93, 150]


def _full_keys_jax(kws) -> np.ndarray:
    """JAX's key words (uint32, most significant first) -> [B, W] object
    array of full keys."""
    out = np.zeros(np.asarray(kws[0]).shape, dtype=object)
    for w in kws:
        out = (out << 32) | np.asarray(w).astype(np.int64).astype(object)
    return out


def _full_keys_port(words, k) -> np.ndarray:
    """The port's words (int64, most significant first) -> full keys."""
    out = np.zeros(tuple(words[0].shape), dtype=object)
    for (_, bases), w in zip(tenc.word_spans(k), words):
        out = (out << (2 * bases)) | w.numpy().astype(object)
    return out


@pytest.mark.parametrize("k", WORD_KS)
def test_encode_words_matches_jnp_and_pallas_sums(k):
    """``encode_words_plain`` equals ``rolling_encode_words_jnp`` as full
    keys, and its sums ``window_quality_sums`` and ``window_qsums_pallas``
    in interpret mode; the composition from H1's plain version
    (``words_from_h1``, as the card runs it) equals it word for word."""
    rng = np.random.default_rng(3000 + k)
    b, l = 6, 4 * ((k + 40) // 4)
    codes = _padded(rng, b, l, 0, 4)
    codes[0, :k + 8] = 3   # all-T windows: at k = 64 the all-ones JAX key
    qual = _padded(rng, b, l, 33, 127)
    packed = torch.from_numpy(tenc.pack_codes_2bit(codes))
    words, qsums = tenc.encode_words_plain(packed, k, torch.from_numpy(qual))
    assert len(words) == -(-k // 31) and all(w.dtype == torch.int64 for w in words)
    assert all(bool((w >= 0).all()) and bool((w >> 62 == 0).all()) for w in words)
    want = _full_keys_jax(jenc.rolling_encode_words_jnp(jnp.asarray(codes), k))
    np.testing.assert_array_equal(_full_keys_port(words, k), want)
    assert want[0, 0] == (1 << (2 * k)) - 1
    want_q = np.asarray(jenc.window_quality_sums(jnp.asarray(qual), k))
    np.testing.assert_array_equal(qsums.numpy(), want_q)
    np.testing.assert_array_equal(
        np.asarray(window_qsums_pallas(jnp.asarray(qual), k, interpret=True)), want_q)
    composed, composed_q = tenc.words_from_h1(packed, k, torch.from_numpy(qual))
    for g, w in zip(composed, words):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    np.testing.assert_array_equal(composed_q.numpy(), qsums.numpy())


def test_encode_words_on_cpu_takes_plain_and_checks_k():
    rng = np.random.default_rng(8)
    packed = torch.from_numpy(tenc.pack_codes_2bit(_padded(rng, 4, 96, 0, 4)))
    before = tenc.encode_window.launches
    words, qsums = tenc.encode_words(packed, 75)
    assert tenc.encode_window.launches == before and qsums is None
    assert [w.shape for w in words] == [(4, 22)] * 3
    assert tenc.word_spans(75) == [(0, 31), (31, 31), (62, 13)]
    assert tenc.word_spans(62) == [(0, 31), (31, 31)]
    # at k <= 31 the one word is the single-key encode
    np.testing.assert_array_equal(tenc.encode_words(packed, 21)[0][0].numpy(),
                                  tenc.rolling_encode(packed, 21).numpy())
    for k in (0, 97):
        with pytest.raises(ValueError):
            tenc.encode_words(packed, k)
