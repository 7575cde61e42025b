"""scaled_mm / int4_mm op tests vs the fp32 oracle (benchmark_mm.py:46-50
pattern: assert against scaled_mm_ref before anything else)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantized_training_tpu import ops
from quantized_training_tpu.ops.scaled_mm import scaled_mm, scaled_mm_ref
from quantized_training_tpu.quant import core


def _rand_int8(key, shape):
    return jax.random.randint(key, shape, -128, 128, dtype=jnp.int8)


class TestScaledMM:
    @pytest.mark.parametrize("m,n,k", [(64, 48, 32), (128, 128, 128)])
    def test_row_col_scale(self, m, n, k):
        k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
        a = _rand_int8(k1, (m, k))
        b = _rand_int8(k2, (k, n))
        sa = jax.random.uniform(k3, (m, 1)) * 0.1
        sb = jax.random.uniform(k4, (1, n)) * 0.1
        out = ops.scaled_mm(a, b, sa, sb, out_dtype=jnp.float32)
        ref = ops.scaled_mm_ref(a, b, sa, sb)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-3, atol=1e-3)

    def test_scalar_col_scale(self):
        # the BitNet COL_SCALE_SCALAR path (triton_mm.py:211-215)
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
        a = _rand_int8(k1, (32, 64))
        b = _rand_int8(k2, (64, 16))
        sa = jax.random.uniform(k3, (32, 1))
        sb = jnp.float32(0.037)
        out = ops.scaled_mm(a, b, sa, sb, out_dtype=jnp.float32)
        ref = ops.scaled_mm_ref(a, b, sa, sb)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-3, atol=1e-3)

    def test_tile_scale(self):
        # DeepSeek-style tile scales (triton_mm.py:223-342)
        M, K, N = 64, 128, 96
        QM, QK, QN = 32, 32, 32
        keys = jax.random.split(jax.random.PRNGKey(2), 4)
        a = _rand_int8(keys[0], (M, K))
        b = _rand_int8(keys[1], (K, N))
        sa = jax.random.uniform(keys[2], (M // QM, K // QK)) * 0.1
        sb = jax.random.uniform(keys[3], (K // QK, N // QN)) * 0.1
        out = ops.scaled_mm(a, b, sa, sb, out_dtype=jnp.float32)
        ref = ops.scaled_mm_ref(a, b, sa, sb)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-3, atol=1e-3)

    def test_int8_mm(self):
        a = _rand_int8(jax.random.PRNGKey(3), (16, 32))
        b = _rand_int8(jax.random.PRNGKey(4), (32, 8))
        out = ops.int8_mm(a, b)
        ref = np.asarray(a, np.int64) @ np.asarray(b, np.int64)
        assert out.dtype == jnp.int32
        np.testing.assert_array_equal(np.asarray(out, np.int64), ref)

    def test_bf16_out_dtype(self):
        a = _rand_int8(jax.random.PRNGKey(5), (8, 16))
        b = _rand_int8(jax.random.PRNGKey(6), (16, 8))
        out = ops.scaled_mm(a, b, jnp.ones((8, 1)), jnp.ones((1, 8)))
        assert out.dtype == jnp.bfloat16


class TestInt4MM:
    def test_int4_mm_vs_unpacked(self):
        key = jax.random.PRNGKey(0)
        x = jax.random.normal(key, (32, 64)) * 2
        y = jax.random.normal(jax.random.PRNGKey(1), (16, 64)) * 2
        xq, _ = core.quantize_int4_rowwise_absmax(x)
        yq, _ = core.quantize_int4_rowwise_absmax(y)
        out = ops.int4_mm(xq, yq)
        ref = np.asarray(ops.unpack_int4(xq), np.int64) @ np.asarray(
            ops.unpack_int4(yq), np.int64
        ).T
        np.testing.assert_array_equal(np.asarray(out, np.int64), ref)

    def test_scaled_int4_mm(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (32, 64)) * 2
        y = jax.random.normal(jax.random.PRNGKey(1), (16, 64)) * 2
        xq, xs = core.quantize_int4_rowwise_absmax(x)
        yq, ys = core.quantize_int4_rowwise_absmax(y)
        out = ops.scaled_int4_mm(xq, yq, xs, ys, out_dtype=jnp.float32)
        ref = ops.scaled_mm_ref(
            ops.unpack_int4(xq),
            ops.unpack_int4(yq).T,
            xs.reshape(-1, 1),
            ys.reshape(1, -1),
        )
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-3, atol=1e-3)
        # and it approximates the fp matmul
        approx = np.asarray(out)
        exact = np.asarray(x @ y.T)
        rel = np.abs(approx - exact).mean() / np.abs(exact).mean()
        assert rel < 0.2, rel


def _operands(dtype, shape_a, shape_b, axes, key=0):
    """Quantized operands with scales along ``axes`` (int8 or fp8 e4m3)."""
    from quantized_training_tpu.ops import fp8 as fp8_ops
    from quantized_training_tpu.quant.core import quantize_int8

    ka, kb = jax.random.split(jax.random.PRNGKey(key))
    a = jax.random.normal(ka, shape_a, jnp.float32)
    b = jax.random.normal(kb, shape_b, jnp.float32)
    q = quantize_int8 if dtype == "int8" else fp8_ops.quantize_fp8
    a_q, sa = q(a, axis=axes[0])
    b_q, sb = q(b, axis=axes[1])
    return a_q, b_q, sa, sb


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dims", [(1, 1), (1, 0), (0, 0)], ids=["fwd", "dgrad", "wgrad"])
def test_scaled_mm_general_forms_match_ref(dtype, dims):
    """Every contraction form of the transpose-free GEMM == scaled_mm_ref on
    the equivalent standard-layout operands."""
    from quantized_training_tpu.ops.scaled_mm import scaled_mm_general

    M, K, N = 48, 256, 80
    shape_a = (M, K) if dims[0] == 1 else (K, M)
    shape_b = (N, K) if dims[1] == 1 else (K, N)
    a_q, b_q, sa, sb = _operands(dtype, shape_a, shape_b, dims)
    out = scaled_mm_general(a_q, b_q, sa, sb, dims=dims, out_dtype=jnp.float32)
    a_std = a_q if dims[0] == 1 else a_q.T
    b_std = b_q if dims[1] == 0 else b_q.T
    ref = scaled_mm_ref(a_std, b_std, sa.reshape(-1, 1), sb.reshape(1, -1))
    assert out.shape == (M, N)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_tile_scaled_xla_matches_ref(dtype):
    """The XLA tile-scaled path (per-K-block partial GEMMs) == the oracle."""
    from quantized_training_tpu.ops import fp8 as fp8_ops

    M, K, N = 128, 384, 256
    ka, kb = jax.random.split(jax.random.PRNGKey(5))
    if dtype == "fp8":
        a_q, sa = fp8_ops.quantize_fp8_tile(jax.random.normal(ka, (M, K)))
        b_q, sb = fp8_ops.quantize_fp8_block(jax.random.normal(kb, (K, N)))
    else:
        a_q = jax.random.randint(ka, (M, K), -127, 128, jnp.int8)
        b_q = jax.random.randint(kb, (K, N), -127, 128, jnp.int8)
        sa = jax.random.uniform(ka, (M, K // 128), minval=0.01, maxval=0.1)
        sb = jax.random.uniform(kb, (K // 128, N // 128), minval=0.01, maxval=0.1)
    out = scaled_mm(a_q, b_q, sa, sb, out_dtype=jnp.float32)
    ref = scaled_mm_ref(a_q, b_q, sa, sb)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("m,k,n", [(64, 256, 96), (128, 128, 256)])
def test_int4_path_matches_ref(m, k, n):
    """Packed int4 -> int8 unpack -> scaled GEMM == the fp32 oracle on the
    unpacked values."""
    from quantized_training_tpu.ops.int4_mm import scaled_int4_mm, unpack_int4
    from quantized_training_tpu.quant.core import quantize_int4_rowwise_absmax

    ka, kb = jax.random.split(jax.random.PRNGKey(6))
    a_p, sa = quantize_int4_rowwise_absmax(jax.random.normal(ka, (m, k)))
    b_p, sb = quantize_int4_rowwise_absmax(jax.random.normal(kb, (n, k)))
    out = scaled_int4_mm(a_p, b_p, sa, sb, out_dtype=jnp.float32)
    ref = scaled_mm_ref(
        unpack_int4(a_p), unpack_int4(b_p).T, sa.reshape(-1, 1), sb.reshape(1, -1)
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-4)
