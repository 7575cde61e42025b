"""Core quantization numerics (pure jnp, CPU-runnable).

These are the implementations of every quantization primitive in the
framework, on the hot path as well: XLA fuses each quantize (absmax
reduce, scale, round, cast) into the surrounding elementwise work.

Behavioral parity targets (cited against the upstream reference repo):
  - int8 absmax row-wise quant:      subclasses/int8.py:13-26
  - int4 group-wise asymmetric:      subclasses/int4.py:42-64
  - int4 row-wise absmax (packed):   subclasses/mixed_precision.py:111-123
  - bitnet ternary + abs-mean scale: subclasses/bitnet.py:110-118
  - 2-bit pack/unpack in int8:       subclasses/bitnet.py:185-201

All functions are functional (no in-place mutation) and take an explicit
PRNG ``key`` wherever the reference used implicit global RNG for stochastic
rounding (``torch.rand_like``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def _unit_uniform(key: Array, shape, dtype=jnp.float32) -> Array:
    """U[0, 1) noise used for stochastic rounding."""
    return jax.random.uniform(key, shape, dtype=dtype)


def stochastic_round_to_int(x: Array, key: Array) -> Array:
    """floor(x + U[0,1)) — unbiased stochastic rounding to integer grid.

    Matches the reference SR formulation (subclasses/int8.py:20-22).
    Returns float values on the integer grid (caller casts/clips).
    """
    return jnp.floor(x + _unit_uniform(key, x.shape, x.dtype))


# ---------------------------------------------------------------------------
# INT8: absmax symmetric, per-row (or arbitrary axis)
# ---------------------------------------------------------------------------


@jax.named_scope("quantize")
def quantize_int8(
    x: Array,
    *,
    axis: int = -1,
    stochastic_rounding: bool = False,
    key: Array | None = None,
    eps: float = 1e-12,
) -> tuple[Array, Array]:
    """Absmax symmetric INT8 quantization along ``axis``.

    Returns ``(int_data int8, scale x.dtype)`` with ``scale`` keeping the
    reduced axis as size-1 (keepdims) so that
    ``dequant = int_data * scale``. Scale is computed in fp32 and cast back
    to the input dtype, exactly like the reference (subclasses/int8.py:13-26).
    """
    orig_dtype = x.dtype

    # absmax reduce on the ORIGINAL dtype: max is exact (pure comparison),
    # and upcasting x before the reduce could make XLA materialize an fp32
    # copy of the whole tensor (it feeds both the reduce and the scaling)
    absmax = jnp.max(jnp.abs(x), axis=axis, keepdims=True).astype(jnp.float32)
    scale = absmax / 127.0
    q = x.astype(jnp.float32) / jnp.clip(scale, min=eps)

    if stochastic_rounding:
        if key is None:
            raise ValueError("stochastic_rounding=True requires a PRNG key")
        q = stochastic_round_to_int(q, key)
    else:
        q = jnp.round(q)  # round-half-to-even, same as torch.round

    q = jnp.clip(q, -128, 127).astype(jnp.int8)
    return q, scale.astype(orig_dtype)


def dequantize_int8(int_data: Array, scale: Array) -> Array:
    return int_data.astype(scale.dtype) * scale


def quantize_int8_both(
    x: Array,
    *,
    stochastic_rounding: bool = False,
    key: Array | None = None,
    eps: float = 1e-12,
) -> tuple[Array, Array, Array, Array]:
    """Quantize ``x`` along BOTH axes: -> (q_row, s_row, q_col, s_col).

    The mixed-precision backward consumes the same output-grad tensor
    rowwise (grad_input) and colwise (grad_weight). Numerics are identical
    to two separate :func:`quantize_int8` calls (non-SR: bit-identical).
    """
    kr = kc = None
    if stochastic_rounding:
        if key is None:
            raise ValueError("stochastic_rounding=True requires a PRNG key")
        kr, kc = jax.random.split(key)
    qr, s_row = quantize_int8(
        x, axis=1, stochastic_rounding=stochastic_rounding, key=kr, eps=eps
    )
    qc, s_col = quantize_int8(
        x, axis=0, stochastic_rounding=stochastic_rounding, key=kc, eps=eps
    )
    return qr, s_row, qc, s_col


# ---------------------------------------------------------------------------
# INT4 group-wise asymmetric (weight-only scheme)
# ---------------------------------------------------------------------------


def quantize_int4_groupwise(
    x: Array,
    group_size: int = 32,
    *,
    stochastic_rounding: bool = False,
    key: Array | None = None,
) -> tuple[Array, Array, Array]:
    """Asymmetric group-wise uint4 quantization, 2 values packed per uint8.

    ``x_fp = zero_point + x_u4 * scale`` with ``x_u4 in [0, 15]``.
    Packing puts the even element in the HIGH nibble:
    ``packed = (x[::2] << 4) | x[1::2]`` (subclasses/int4.py:42-64).

    Returns (packed uint8 [n_groups, group_size//2], scale [n_groups],
    zero_point [n_groups]) — both scale/zp in x.dtype.
    """
    orig_dtype = x.dtype
    xf = x.astype(jnp.float32).reshape(-1, group_size)

    zero_point = jnp.min(xf, axis=-1)
    shifted = xf - zero_point[:, None]
    scale = jnp.max(shifted, axis=-1) / 15.0
    q = shifted / jnp.clip(scale, min=1e-12)[:, None]

    if stochastic_rounding:
        if key is None:
            raise ValueError("stochastic_rounding=True requires a PRNG key")
        # floor not required in the reference since uint8 cast truncates;
        # we floor explicitly (identical for non-negative values).
        q = jnp.floor(q + _unit_uniform(key, q.shape, q.dtype))
    else:
        q = jnp.round(q)

    q = jnp.clip(q, 0, 15).astype(jnp.uint8)
    packed = (q[:, ::2] << 4) | q[:, 1::2]
    return packed, scale.astype(orig_dtype), zero_point.astype(orig_dtype)


def dequantize_int4_groupwise(
    packed: Array, scale: Array, zero_point: Array, shape: tuple[int, ...]
) -> Array:
    """Inverse of :func:`quantize_int4_groupwise` (subclasses/int4.py:73-76)."""
    # packed is [n_groups, group_size//2]; recover u4 pairs
    hi = packed >> 4
    lo = packed & 0xF
    u4 = jnp.stack([hi, lo], axis=-1).reshape(packed.shape[0], -1)
    out = zero_point[:, None] + u4.astype(scale.dtype) * scale[:, None]
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# INT4 row-wise absmax, signed, packed (mixed-precision int4 matmul operands)
# ---------------------------------------------------------------------------


def quantize_int4_rowwise_absmax(x: Array) -> tuple[Array, Array]:
    """Signed row-wise int4 quantization with asymmetric-range absmax scale.

    ``pos_scale = max(relu(x)) / 7``, ``neg_scale = max(relu(-x)) / 8``,
    ``scale = max(pos, neg)`` — uses the full [-8, 7] signed range
    (subclasses/mixed_precision.py:111-123). Values are packed two per int8
    with the even element in the HIGH nibble.

    Returns (packed int8 [M, N//2], scale fp [M]).
    """
    orig_dtype = x.dtype
    pos_scale = jnp.max(jax.nn.relu(x), axis=1) / 7.0
    neg_scale = jnp.max(jax.nn.relu(-x), axis=1) / 8.0
    scale = jnp.maximum(pos_scale, neg_scale)

    inv_scale = 1.0 / jnp.clip(scale.astype(jnp.float32), min=1e-12)
    q = jnp.round(x.astype(jnp.float32) * inv_scale[:, None]).astype(jnp.int8)
    packed = (q[:, ::2] << 4) | (q[:, 1::2] & 0xF)
    return packed, scale.astype(orig_dtype)


def unpack_int4_rowwise(packed: Array) -> Array:
    """Unpack signed int4 pairs (high nibble first) back to int8 values.

    Sign extension via left-then-arithmetic-right shift on int8.
    """
    hi = packed >> 4  # arithmetic shift on int8 sign-extends
    lo = (packed << 4).astype(jnp.int8) >> 4
    return jnp.stack([hi, lo], axis=-1).reshape(packed.shape[0], -1)


# ---------------------------------------------------------------------------
# BitNet 1.58-bit: ternary weights, tensor-wise abs-mean scale
# ---------------------------------------------------------------------------


def get_bitnet_scale(x: Array) -> Array:
    """Tensor-wise abs-mean, always fp32 (subclasses/bitnet.py:110-112)."""
    return jnp.mean(jnp.abs(x.astype(jnp.float32)))


def quantize_bitnet_weight(w: Array, scale: Array, eps: float = 1e-5) -> Array:
    """Ternarize to {-1, 0, 1} int8 (subclasses/bitnet.py:115-118)."""
    wf = w.astype(jnp.float32) / jnp.clip(scale, min=eps)
    return jnp.clip(jnp.round(wf), -1, 1).astype(jnp.int8)


def pack_i2_in_i8(x: Array) -> Array:
    """Pack 4 ternary int8 values (2-bit each) into one int8.

    [aa, bb, cc, dd] -> 0baabbccdd, masking the low 2 bits before shifting
    because values are signed (subclasses/bitnet.py:185-195).
    Input last dim must be divisible by 4; returns [..., N//4] int8.
    """
    x0 = x[..., 0::4] << 6
    x1 = (x[..., 1::4] & 0b11) << 4
    x2 = (x[..., 2::4] & 0b11) << 2
    x3 = x[..., 3::4] & 0b11
    return (x0 | x1 | x2 | x3).astype(jnp.int8)


def unpack_i2_in_i8(x: Array) -> Array:
    """Unpack int8 -> 4 sign-extended ternary int8 values.

    Left-shift then arithmetic right-shift performs sign extension
    (subclasses/bitnet.py:198-201). Returns [..., N*4] int8.
    """
    parts = [
        x >> 6,
        (x << 2).astype(jnp.int8) >> 6,
        (x << 4).astype(jnp.int8) >> 6,
        (x << 6).astype(jnp.int8) >> 6,
    ]
    return jnp.stack(parts, axis=-1).reshape(*x.shape[:-1], x.shape[-1] * 4)


# ---------------------------------------------------------------------------
# BF16 stochastic rounding via the int32 bit trick (optimizer writeback)
# ---------------------------------------------------------------------------


def bf16_stochastic_round(x_f32: Array, key: Array) -> Array:
    """FP32 -> BF16 with stochastic rounding via random 16-bit addition.

    Reinterpret fp32 as int32, add 16 random low bits, truncate the low 16
    bits, reinterpret as fp32, cast to bf16 — bit-exact semantics of the
    reference optimizer writeback (other_optim/bf16_sr.py:108-122).
    """
    assert x_f32.dtype == jnp.float32
    bits = jax.lax.bitcast_convert_type(x_f32, jnp.int32)
    rand = jax.random.randint(
        key, x_f32.shape, minval=0, maxval=1 << 16, dtype=jnp.int32
    )
    bits = bits + rand
    bits = bits & jnp.int32(-65536)  # 0xFFFF0000: truncate the low 16 bits
    return jax.lax.bitcast_convert_type(bits, jnp.float32).astype(jnp.bfloat16)
