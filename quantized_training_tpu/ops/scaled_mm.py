"""Scaled matmul op family — the workhorse of every quantized scheme.

Semantics mirror the reference kernel contracts
(kernels/gn_kernels/triton_mm.py:146-342, :349-373):

  ``scaled_mm(A, B, scale_a, scale_b)`` computes
  ``(A @ B).astype(f32) * scale_a * scale_b`` cast to ``out_dtype``, where

  - A: [M, K] int8 (or fp8/bf16), B: [K, N] same dtype
  - scale_a: row scale [M, 1], tensor scalar, or tile scale [M/QM, K/QK]
  - scale_b: col scale [1, N], tensor scalar (the BitNet ``COL_SCALE_SCALAR``
    path, triton_mm.py:211-215), or tile scale [K/QK, N/QN]

All forms lower through XLA: ``dot_general`` with
``preferred_element_type`` (int8 -> int32, exact) becomes a cuBLAS(Lt) or
XLA-generated GEMM, and the fp32 scale epilogue fuses into its consumer.
fp8 operands are upcast to bf16 before the dot (exact for e4m3/e5m2) and
the dot is pinned to bf16 inputs with fp32 accumulation (see :func:`_dot`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

_INT_TYPES = (jnp.int8, jnp.int4)
_FP8_TYPES = (jnp.float8_e4m3fn, jnp.float8_e5m2)


def _accum_dtype(a_dtype) -> jnp.dtype:
    return jnp.int32 if a_dtype in (jnp.int8,) else jnp.float32


def _is_tensor_scale(s: Array) -> bool:
    return s.ndim == 0 or s.size == 1


def int8_mm(a: Array, b: Array) -> Array:
    """Plain INT8 x INT8 -> INT32 matmul (triton_mm.py:112-128 contract)."""
    assert a.dtype == jnp.int8 and b.dtype == jnp.int8
    return jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )


def _dot(a: Array, b: Array, contract, batch=((), ())) -> Array:
    """``dot_general`` accumulated exactly (int8 -> int32) or in fp32.

    fp8 operands are upcast to bf16 (exact) and every bf16 dot is pinned to
    the BF16_BF16_F32 algorithm. Without the pin, XLA's GPU compiler folds
    the upcast back into a cuBLASLt fp8 GEMM, whose fp8 accumulation on
    Hopper errs by ~1e-4 (relative L2 at K=2048) and by ~1e-3 with its fast
    accumulation; the pinned GEMM runs on the bf16 tensor cores and errs
    only by fp32 rounding.
    """
    if a.dtype in _FP8_TYPES:
        a = a.astype(jnp.bfloat16)
        b = b.astype(jnp.bfloat16)
    precision = (
        jax.lax.DotAlgorithmPreset.BF16_BF16_F32 if a.dtype == jnp.bfloat16 else None
    )
    return jax.lax.dot_general(
        a, b, (contract, batch), precision=precision,
        preferred_element_type=_accum_dtype(a.dtype),
    )


def scaled_mm(
    a: Array,
    b: Array,
    scale_a: Array,
    scale_b: Array,
    *,
    out_dtype=jnp.bfloat16,
) -> Array:
    """Row/col/tensor/tile-scaled matmul (triton_mm.py:349-373 dispatcher).

    Scale layout decides the mode:
      - scale_a [M,1] or scalar AND scale_b [1,N] or scalar -> fused epilogue
      - scale_a [M/QM, K/QK] AND scale_b [K/QK, N/QN]       -> tile-scaled
    """
    M, K = a.shape
    K2, N = b.shape
    assert K == K2, f"shape mismatch {a.shape} @ {b.shape}"
    assert a.dtype == b.dtype or {a.dtype, b.dtype} <= set(_FP8_TYPES)

    row_col_mode = (_is_tensor_scale(scale_a) or scale_a.shape == (M, 1)) and (
        _is_tensor_scale(scale_b) or scale_b.shape == (1, N)
    )

    if row_col_mode:
        acc = _dot(a, b, ((1,), (0,))).astype(jnp.float32)
        sa = jnp.reshape(scale_a.astype(jnp.float32), (1, 1) if _is_tensor_scale(scale_a) else (M, 1))
        sb = jnp.reshape(scale_b.astype(jnp.float32), (1, 1) if _is_tensor_scale(scale_b) else (1, N))
        return (acc * sa * sb).astype(out_dtype)

    # tile-scaled (DeepSeek-style) mode: triton_mm.py:223-342
    assert scale_a.ndim == 2 and scale_b.ndim == 2, (
        f"unrecognized scale shapes {scale_a.shape}, {scale_b.shape} for "
        f"A[{M},{K}] @ B[{K},{N}]"
    )
    assert K % scale_a.shape[1] == 0 and scale_a.shape[1] == scale_b.shape[0]
    return _tile_scaled_mm_xla(a, b, scale_a, scale_b, out_dtype)


def scaled_mm_general(
    a: Array,
    b: Array,
    scale_a: Array,
    scale_b: Array,
    *,
    dims: tuple[int, int] = (1, 0),
    out_dtype=jnp.bfloat16,
) -> Array:
    """Row/col-scaled matmul with explicit contraction dims — the
    transpose-free form used by the mixed-precision backward pass.

    ``dims = (ca, cb)`` contracts ``a`` over axis ``ca`` and ``b`` over
    axis ``cb`` (each operand quantized along its contraction axis, so the
    scales lie off the reduction dim). Avoids materializing ``x.T`` /
    ``w.T`` operands: XLA folds the layout choice into the GEMM, where an
    explicit ``jnp.transpose`` before the quantize costs a full pass over
    device memory.

    scale_a has size a.shape[1-ca] (per out-row), scale_b size
    b.shape[1-cb] (per out-col); scalars broadcast.
    """
    ca, cb = dims
    M = a.shape[1 - ca]
    N = b.shape[1 - cb]
    acc = _dot(a, b, ((ca,), (cb,))).astype(jnp.float32)
    sa = jnp.reshape(scale_a.astype(jnp.float32), (1, 1) if _is_tensor_scale(scale_a) else (M, 1))
    sb = jnp.reshape(scale_b.astype(jnp.float32), (1, 1) if _is_tensor_scale(scale_b) else (1, N))
    return (acc * sa * sb).astype(out_dtype)


def _tile_scaled_mm_xla(
    a: Array, b: Array, scale_a: Array, scale_b: Array, out_dtype
) -> Array:
    """Tile-scaled matmul in XLA.

    Computes per-K-block partial products (one batched GEMM over the K
    blocks), then applies the block scales and reduces — the
    two-accumulator structure of triton_mm.py:288-331 expressed as a
    batched dot. The fp32 partials [K/QK, M, N] are materialized.
    """
    M, K = a.shape
    N = b.shape[1]
    n_qm, n_qk = scale_a.shape
    n_qk2, n_qn = scale_b.shape
    qm, qk, qn = M // n_qm, K // n_qk, N // n_qn

    a3 = a.reshape(M, n_qk, qk).transpose(1, 0, 2)  # [KB, M, qk]
    b3 = b.reshape(n_qk, qk, N)  # [KB, qk, N]
    part = _dot(a3, b3, ((2,), (1,)), ((0,), (0,))).astype(jnp.float32)  # [KB, M, N]

    sa = jnp.repeat(scale_a.astype(jnp.float32), qm, axis=0).T  # [KB, M]
    sb = jnp.repeat(scale_b.astype(jnp.float32), qn, axis=1)  # [KB, N]
    # a scaled sum over the K blocks (a reduction, not a TF32 matmul)
    out = jnp.sum(part * sa[:, :, None] * sb[:, None, :], axis=0)
    return out.astype(out_dtype)


def scaled_mm_ref(
    a: Array, b: Array, scale_a: Array, scale_b: Array, *, out_dtype=jnp.float32
) -> Array:
    """Pure-fp32 oracle used by tests/benchmarks (benchmark_mm.py:46-50).

    Expands any scale layout to full [M,K] / [K,N] grids, multiplies into
    fp32 operands, and matmuls.
    """
    M, K = a.shape
    N = b.shape[1]
    af = a.astype(jnp.float32)
    bf = b.astype(jnp.float32)

    def expand(s, rows, cols):
        s = s.astype(jnp.float32)
        if s.ndim == 0 or s.size == 1:
            return jnp.broadcast_to(jnp.reshape(s, (1, 1)), (rows, cols))
        r = jnp.repeat(s, rows // s.shape[0], axis=0)
        return jnp.repeat(r, cols // s.shape[1], axis=1)

    return jnp.dot(
        af * expand(scale_a, M, K),
        bf * expand(scale_b, K, N),
        precision="highest",  # fp32 matmuls may run in TF32 otherwise
    ).astype(out_dtype)
