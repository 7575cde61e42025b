"""The card's kernels at real widths against their plain references.

Marked ``gpu``: they compile for the card and skip elsewhere (the ``gpu``
fixture decides when the test runs). Run on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantized_training_tpu.models import llama
from quantized_training_tpu.ops import conv as conv_ops
from quantized_training_tpu.ops import fp8, scaled_mm_general, scaled_mm_ref
from quantized_training_tpu.ops.scaled_mm import scaled_mm
from quantized_training_tpu.quant.core import quantize_int8

pytestmark = pytest.mark.gpu

# llama2-1b step shapes: 4 x 2048 tokens, D 2048, F 5632, 32 heads, KV 4
M, K, N = 8192, 2048, 5632


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_cudnn_attention_matches_fp32_reference(gpu):
    """Out within 1e-2 and grads within 2e-2 relative L2: cuDNN rounds P to
    bf16 before PV, the reference keeps everything fp32 at 'highest'."""
    B, S, H, KV, hd = 4, 2048, 32, 4, 64
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    q = jax.random.normal(ks[0], (B, S, H, hd), jnp.bfloat16)
    k = jax.random.normal(ks[1], (B, S, KV, hd), jnp.bfloat16)
    v = jax.random.normal(ks[2], (B, S, KV, hd), jnp.bfloat16)
    dout = jax.random.normal(ks[3], (B, S, H, hd), jnp.float32)

    def loss(f, *qkv):
        return jnp.sum(f(*qkv).astype(jnp.float32) * dout)

    cudnn = lambda *t: llama.attention(*t, impl="cudnn")
    out, grads = jax.jit(jax.value_and_grad(lambda *t: (loss(cudnn, *t), cudnn(*t)),
                                            argnums=(0, 1, 2), has_aux=True))(q, k, v)
    out = out[1]
    f32 = [t.astype(jnp.float32) for t in (q, k, v)]
    ref = jax.jit(llama.attention_ref)(*f32)
    ref_grads = jax.jit(jax.grad(lambda *t: loss(llama.attention_ref, *t), argnums=(0, 1, 2)))(*f32)
    assert _rel(out, ref) <= 1e-2
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) <= 2e-2


def _int8_operands(dims):
    ca, cb = dims
    ka, kb = jax.random.split(jax.random.PRNGKey(1))
    a = jax.random.normal(ka, (M, K) if ca == 1 else (K, M), jnp.bfloat16)
    b = jax.random.normal(kb, (N, K) if cb == 1 else (K, N), jnp.bfloat16)
    a_q, sa = quantize_int8(a, axis=ca)
    b_q, sb = quantize_int8(b, axis=cb)
    return a_q, b_q, sa.astype(jnp.float32), sb.astype(jnp.float32)


@pytest.mark.parametrize("dims", [(1, 1), (1, 0), (0, 0)], ids=["fwd", "dgrad", "wgrad"])
def test_int8_scaled_gemm_forms(gpu, dims):
    """int32 accumulation is exact, so only the fp32 epilogue rounds."""
    a_q, b_q, sa, sb = _int8_operands(dims)
    f = jax.jit(lambda *t: scaled_mm_general(*t, dims=dims, out_dtype=jnp.float32))
    out = f(a_q, b_q, sa, sb)
    a_std = a_q if dims[0] == 1 else a_q.T
    b_std = b_q if dims[1] == 0 else b_q.T
    ref = scaled_mm_ref(a_std, b_std, sa.reshape(-1, 1), sb.reshape(1, -1))
    assert _rel(out, ref) <= 1e-4
    hlo = f.lower(a_q, b_q, sa, sb).compile().as_text()
    # the s8 dot becomes a library or generated GEMM, not a loop
    assert "cublas" in hlo or "__triton_gemm" in hlo or "triton" in hlo, hlo[:2000]


@pytest.mark.parametrize("mode", ["row", "tile"])
def test_fp8_scaled_gemm(gpu, mode):
    """The fp8 operands reach the GEMM as bf16 (exact) with fp32
    accumulation, so only fp32 rounding is left; the GEMM must not be a
    cuBLASLt fp8 one, whose fp8 accumulation misses the bound."""
    ka, kb = jax.random.split(jax.random.PRNGKey(2))
    a = jax.random.normal(ka, (M, K), jnp.bfloat16)
    b = jax.random.normal(kb, (K, N), jnp.bfloat16)
    if mode == "row":
        a_q, sa = fp8.quantize_fp8(a, axis=1)
        b_q, sb = fp8.quantize_fp8(b, axis=0)
    else:
        a_q, sa = fp8.quantize_fp8_tile(a)
        b_q, sb = fp8.quantize_fp8_block(b)
    sa, sb = sa.astype(jnp.float32), sb.astype(jnp.float32)
    f = jax.jit(lambda *t: scaled_mm(*t, out_dtype=jnp.float32))
    out = f(a_q, b_q, sa, sb)
    ref = scaled_mm_ref(a_q, b_q, sa, sb)
    assert _rel(out, ref) <= 1e-4
    assert "$f8" not in f.lower(a_q, b_q, sa, sb).compile().as_text()


def test_int8_patch_conv(gpu):
    """ViT-Base's patch-embedding shape as an s8 x s8 -> s32 NHWC conv. The
    fp32 reference is exact: |sum| <= 768 * 127^2 < 2^24."""
    kx, kw = jax.random.split(jax.random.PRNGKey(3))
    x = jax.random.randint(kx, (64, 224, 224, 3), -127, 128, jnp.int8)
    w = jax.random.randint(kw, (16, 16, 3, 768), -127, 128, jnp.int8)
    out = jax.jit(lambda x, w: conv_ops.int8_conv2d(x, w, stride=16))(x, w)
    ref = jax.jit(lambda x, w: jnp.einsum(
        "bhpwqc,pqco->bhwo",
        x.reshape(64, 14, 16, 14, 16, 3).astype(jnp.float32),
        w.astype(jnp.float32), precision="highest",
    ))(x, w)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref).astype(np.int32))


def test_int8_conv_past_fp32_integer_range(gpu):
    """A 3x3 conv over 256 channels sums 2304 products; with large
    same-sign values the sum passes 2^24, so only the channel groups of
    ``conv_ops.conv2d`` keep the int32 result exact."""
    kx, kw = jax.random.split(jax.random.PRNGKey(4))
    x = jax.random.randint(kx, (4, 28, 28, 256), 100, 128, jnp.int8)
    w = jax.random.randint(kw, (3, 3, 256, 256), 100, 128, jnp.int8)
    out = np.asarray(jax.jit(lambda x, w: conv_ops.int8_conv2d(x, w, padding=1))(x, w))
    xp = np.pad(np.asarray(x, np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    cols = np.stack([xp[:, i : i + 28, j : j + 28] for i in range(3) for j in range(3)], axis=3)
    ref = cols.reshape(-1, 9 * 256) @ np.asarray(w, np.float64).reshape(9 * 256, 256)
    assert np.abs(ref).max() > 2**24
    np.testing.assert_array_equal(out.reshape(-1, 256), ref.astype(np.int64))
