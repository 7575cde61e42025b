"""The jnp int8 quantize against a float64 numpy oracle.

``quantize_int8`` is the one quantize implementation on every platform
(XLA fuses it): absmax / 127 scales along the reduced axis, round half to
even, clip to [-128, 127]. The oracle computes the same in float64; the
jnp path divides in fp32, so a value landing within an fp32 rounding of a
.5 tie may round the other way (at most 1 LSB, rarely).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantized_training_tpu.quant.core import quantize_int8, quantize_int8_both


def oracle(x, axis):
    x = np.asarray(x, np.float64)
    scale = np.abs(x).max(axis=axis, keepdims=True) / 127.0
    q = np.clip(np.round(x / np.maximum(scale, 1e-12)), -128, 127)
    return q.astype(np.int32), scale


def check(q, s, x, axis, dtype):
    q_ref, s_ref = oracle(np.asarray(x, np.float32), axis)
    # the scale comes back in the input dtype (bf16 keeps 8 bits)
    rtol = 1e-2 if dtype == jnp.bfloat16 else 1e-6
    np.testing.assert_allclose(np.asarray(s, np.float64), s_ref, rtol=rtol)
    diff = np.abs(np.asarray(q, np.int32) - q_ref)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("shape", [(64, 128), (256, 384), (96, 256)])
@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_matches_float64_oracle(shape, axis, dtype):
    x = jax.random.normal(jax.random.PRNGKey(0), shape, dtype) * 3.0
    q, s = quantize_int8(x, axis=axis)
    assert q.dtype == jnp.int8 and s.dtype == dtype
    assert s.shape == tuple(1 if i == axis else d for i, d in enumerate(shape))
    check(q, s, x, axis, dtype)


@pytest.mark.parametrize("shape", [(64, 128), (256, 384)])
def test_both_axes_equal_separate_calls(shape):
    """quantize_int8_both == (rowwise, colwise) bit-exactly (non-SR)."""
    x = jax.random.normal(jax.random.PRNGKey(3), shape, jnp.bfloat16) * 2.0
    qr, sr, qc, sc = quantize_int8_both(x)
    for (q, s), axis in (((qr, sr), 1), ((qc, sc), 0)):
        q_ref, s_ref = quantize_int8(x, axis=axis)
        np.testing.assert_array_equal(np.asarray(q), np.asarray(q_ref))
        np.testing.assert_array_equal(np.asarray(s, np.float32), np.asarray(s_ref, np.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_roundtrip_within_half_step(dtype):
    x = jax.random.normal(jax.random.PRNGKey(1), (128, 256), dtype)
    q, s = quantize_int8(x, axis=1)
    recon = np.asarray(q, np.float64) * np.asarray(s, np.float64)
    step = np.asarray(s, np.float64)
    # half a quantization step, plus the bf16 rounding of the scale itself
    slack = 0.5 + (0.01 * 128 if dtype == jnp.bfloat16 else 1e-4)
    assert (np.abs(recon - np.asarray(x, np.float64)) <= step * slack).all()


def test_wide_contraction_axis():
    """A 20480-wide row quantizes in one reduction, same as the oracle."""
    x = jax.random.normal(jax.random.PRNGKey(0), (32, 20480), jnp.float32) * 2
    q, s = quantize_int8(x, axis=1)
    check(q, s, x, 1, jnp.float32)


@pytest.mark.parametrize("axis", [1, 0])
def test_sr_deterministic_in_key(axis):
    x = jax.random.normal(jax.random.PRNGKey(2), (128, 256))
    k = jax.random.PRNGKey(7)
    q1, _ = quantize_int8(x, axis=axis, stochastic_rounding=True, key=k)
    q2, _ = quantize_int8(x, axis=axis, stochastic_rounding=True, key=k)
    q3, _ = quantize_int8(x, axis=axis, stochastic_rounding=True, key=jax.random.PRNGKey(8))
    np.testing.assert_array_equal(np.asarray(q1), np.asarray(q2))
    assert (np.asarray(q1) != np.asarray(q3)).any()


@pytest.mark.parametrize("axis", [1, 0])
def test_sr_unbiased(axis):
    """Values 0.3 of a step above the grid round up 30 % of the time."""
    x = jnp.full((256, 256), 0.3, jnp.float32)
    x = x.at[:, 0].set(127.0) if axis == 1 else x.at[0, :].set(127.0)
    keys = jax.random.split(jax.random.PRNGKey(0), 64)
    q = jax.vmap(lambda k: quantize_int8(x, axis=axis, stochastic_rounding=True, key=k)[0])(keys)
    interior = np.asarray(q[:, :, 1:] if axis == 1 else q[:, 1:, :], np.float64)
    assert set(np.unique(interior)) <= {0.0, 1.0}
    assert abs(interior.mean() - 0.3) < 5e-3
