"""INT4 matmul ops.

Contract parity with the reference CUTLASS SM80 kernels
(kernels/csrc/cutlass_sm80_int4.cu:32-173, wrapped at
kernels/gn_kernels/cutlass_mm.py:25-56):

  - ``int4_mm(A_packed, B_t_packed)``: s4 x s4 -> s32
  - ``scaled_int4_mm(A_packed, B_t_packed, row_scale, col_scale)``:
    fused ``acc.f32 * row_scale[M,1] * col_scale[1,N]`` epilogue -> bf16

Hopper has no int4 tensor cores, so packed int4 operands are unpacked to
int8 values (exact) and run as int8 GEMMs. The unpack is in-graph: XLA
writes the [.., 2P] int8 operands before the GEMM (twice the packed bytes).

Packing layout: two signed int4 per int8, even element in the HIGH nibble
(subclasses/mixed_precision.py:121-122). B is taken in transposed-packed
form ``B_t_packed [N, K//2]`` (packed along K) — the natural layout produced
by row-wise quantization of B.T.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .scaled_mm import scaled_mm

Array = jax.Array


def unpack_int4(packed: Array) -> Array:
    """[..., P] int8 (2 nibbles each) -> [..., 2P] int8 values in [-8, 7]."""
    hi = packed >> 4  # arithmetic shift sign-extends
    lo = (packed << 4).astype(jnp.int8) >> 4
    return jnp.stack([hi, lo], axis=-1).reshape(*packed.shape[:-1], -1)


def int4_mm(a_packed: Array, b_t_packed: Array) -> Array:
    """A[M, K//2] packed @ B.T[N, K//2] packed -> int32 [M, N]."""
    a = unpack_int4(a_packed)
    b = unpack_int4(b_t_packed)
    return jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
    )


def scaled_int4_mm(
    a_packed: Array,
    b_t_packed: Array,
    row_scale: Array,
    col_scale: Array,
    *,
    out_dtype=jnp.bfloat16,
) -> Array:
    """Row/col-scaled INT4 matmul -> out_dtype.

    row_scale: [M] or [M, 1]; col_scale: [N] or [1, N]
    (cutlass_mm.py:50-56 contract).
    """
    a = unpack_int4(a_packed)
    b = unpack_int4(b_t_packed).T  # [K, N]
    rs = row_scale.reshape(-1, 1)
    cs = col_scale.reshape(1, -1)
    return scaled_mm(a, b, rs, cs, out_dtype=out_dtype)
