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
