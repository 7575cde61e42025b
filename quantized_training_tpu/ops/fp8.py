"""FP8 matmul + quantization ops.

Contract parity with the reference FP8 kernels (cutlass_sm89_fp8.cu:28-158,
cutlass_sm120a_fp8.cu:35-217, wrapped at cutlass_mm.py:36-71):
  - ``fp8_mm(A, B)``: e4m3 x e4m3 (or e5m2 grads) -> bf16
  - ``scaled_fp8_mm(A, B, row_scale, col_scale)``: fused fp32 row/col
    scale epilogue -> bf16
  - ``quantize_fp8(x, axis, dtype)``: absmax row-wise cast to fp8

fp8 operands are upcast to bf16 for the dot (numerics match: every fp8
value is exactly representable in bf16), so these GEMMs run on the bf16
tensor cores, not the fp8 ones (scaled_mm._dot keeps XLA from folding
the upcast back into an fp8 GEMM).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .scaled_mm import _dot, scaled_mm

Array = jax.Array

E4M3 = jnp.float8_e4m3fn
E5M2 = jnp.float8_e5m2
_AMAX = {E4M3: 448.0, E5M2: 57344.0}


@jax.named_scope("quantize")
def quantize_fp8(
    x: Array, *, axis: int = -1, dtype=E4M3, eps: float = 1e-12
) -> tuple[Array, Array]:
    """Absmax row-wise FP8 quantization: returns (fp8 data, fp scale) with
    dequant = data * scale (same scale layout contract as quantize_int8)."""
    absmax = jnp.max(jnp.abs(x), axis=axis, keepdims=True).astype(jnp.float32)
    scale = absmax / _AMAX[dtype]
    q = (x.astype(jnp.float32) / jnp.clip(scale, min=eps)).astype(dtype)
    return q, scale.astype(x.dtype)


@jax.named_scope("quantize")
def quantize_fp8_tile(
    x: Array, *, group: int = 128, dtype=E4M3, eps: float = 1e-12
) -> tuple[Array, Array]:
    """DeepSeek-style 1 x ``group`` activation quantization along the
    contraction (last) axis: x [M, K] -> (fp8 [M, K], scale [M, K/group]).

    The scale layout is exactly what ``scaled_mm``'s tile branch consumes
    (triton_mm.py:223-342 contract; scaling-book fp8 recipe)."""
    M, K = x.shape
    assert K % group == 0, f"K={K} not a multiple of group={group}"
    xg = x.reshape(M, K // group, group)
    absmax = jnp.max(jnp.abs(xg), axis=-1, keepdims=True).astype(jnp.float32)
    scale = absmax / _AMAX[dtype]
    q = (xg.astype(jnp.float32) / jnp.clip(scale, min=eps)).astype(dtype)
    return q.reshape(M, K), scale[..., 0].astype(x.dtype)


@jax.named_scope("quantize")
def quantize_fp8_block(
    x: Array, *, block: int = 128, dtype=E4M3, eps: float = 1e-12
) -> tuple[Array, Array]:
    """``block`` x ``block`` weight quantization: x [K, N] -> (fp8 [K, N],
    scale [K/block, N/block]) — the B-operand layout of the tile-scaled
    matmul (DeepSeek-V3 recipe: 128x128 weight blocks)."""
    K, N = x.shape
    assert K % block == 0 and N % block == 0, (
        f"[{K},{N}] not a multiple of block={block}"
    )
    xb = x.reshape(K // block, block, N // block, block)
    absmax = jnp.max(jnp.abs(xb), axis=(1, 3), keepdims=True).astype(jnp.float32)
    scale = absmax / _AMAX[dtype]
    q = (xb.astype(jnp.float32) / jnp.clip(scale, min=eps)).astype(dtype)
    return q.reshape(K, N), scale[:, 0, :, 0].astype(x.dtype)


def fp8_mm(a: Array, b: Array, *, out_dtype=jnp.bfloat16) -> Array:
    """A[M,K] fp8 @ B[K,N] fp8 -> out_dtype (cutlass_mm.py:36-42)."""
    assert a.dtype in (E4M3, E5M2) and b.dtype in (E4M3, E5M2)
    return _dot(a, b, ((1,), (0,))).astype(out_dtype)


def scaled_fp8_mm(
    a: Array,
    b: Array,
    row_scale: Array,
    col_scale: Array,
    *,
    out_dtype=jnp.bfloat16,
) -> Array:
    """Row/col-scaled FP8 matmul (cutlass_mm.py:59-71 contract:
    A e4m3, B e4m3 or e5m2, fp32 scales)."""
    assert a.dtype in (E4M3, E5M2) and b.dtype in (E4M3, E5M2)
    return scaled_mm(a, b, row_scale, col_scale, out_dtype=out_dtype)
