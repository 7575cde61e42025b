"""MX (OCP microscaling) and NVFP4 block quantization.

Behavioral parity with kernels/gn_kernels/utils.py:
  - absmax -> E8M0 power-of-two scales, OCP (:45-49) and NV cuBLAS
    round-up (:30-41) variants, via fp32 exponent bit manipulation
  - fp32 -> FP4-E2M1 conversion by explicit decision thresholds (:52-80),
    packed two nibbles per uint8
  - quantize_mx: 32-element blocks, E8M0 scales (:83-107)
  - dequantize_mxfp4 via the 16-entry E2M1 LUT (:110-142)
  - quantize_nvfp4: 16-element blocks, FP8-E4M3 scales + fp32 tensor scale
    (:146-166)
  - pack_block_scales_nv: the NVIDIA 128x4 swizzled scale layout
    (:21-26) — kept for kernel-contract parity/interop; no kernel here
    consumes it

There are no fp4 tensor cores on Hopper; the matmul ops below dequantize
to bf16 in the graph and run a bf16 GEMM. The quantization math here is
bit-exact with the reference so checkpoints/payloads interop.

Nibble packing order: LOW nibble = even element, matching the reference's
packed-in-int32 order (utils.py:66-80: element 0 -> bits 0-3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

F8E4M3 = jnp.float8_e4m3fn
F8E5M2 = jnp.float8_e5m2
E8M0 = jnp.float8_e8m0fnu

DTYPE_AMAX = {F8E4M3: 448.0, F8E5M2: 57344.0, "fp4": 6.0}
DTYPE_POW2_AMAX = {F8E4M3: 256.0, F8E5M2: 32768.0, "fp4": 4.0}

# E2M1 value table (utils.py:114-118)
FP4E2M1_LUT = jnp.asarray(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
     -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0],
    jnp.float32,
)


def _f32_bits(x: Array) -> Array:
    return jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)


def absmax_to_mx_scales_nv(absmax: Array, dtype) -> Array:
    """cuBLAS round-up E8M0 exponent (utils.py:30-41). Returns int32 bits."""
    assert absmax.dtype == jnp.float32
    scales = absmax / DTYPE_AMAX[dtype]
    bits = jax.lax.bitcast_convert_type(scales, jnp.int32)
    exponent = bits >> 23  # positive input, sign bit 0
    mantissa = bits & 0x7FFFFF
    round_up = ((exponent > 0) & (exponent < 254) & (mantissa > 0)) | (
        (exponent == 0) & (mantissa > 0x400000)
    )
    return jnp.where(round_up, exponent + 1, exponent)


def absmax_to_mx_scales_ocp(absmax: Array, dtype) -> Array:
    """OCP spec: floor-to-pow2 of absmax / pow2_amax (utils.py:45-49)."""
    assert absmax.dtype == jnp.float32
    bits = jax.lax.bitcast_convert_type(absmax, jnp.int32)
    pow2 = jax.lax.bitcast_convert_type(bits & 0x7F800000, jnp.float32)
    return jax.lax.bitcast_convert_type(
        pow2 / DTYPE_POW2_AMAX[dtype], jnp.int32
    ) >> 23


def fp32_to_fp4e2m1(x: Array) -> Array:
    """fp32 -> E2M1 4-bit codes (round-to-nearest-even thresholds,
    utils.py:52-67). Returns int32 codes in [0, 15] (unpacked)."""
    sign = (_f32_bits(x) >> 31) & 0x1
    a = jnp.abs(x)
    nosign = jnp.where(a <= 5.0, 0b0110, 0b0111)
    nosign = jnp.where(a < 3.5, 0b0101, nosign)
    nosign = jnp.where(a <= 2.5, 0b0100, nosign)
    nosign = jnp.where(a < 1.75, 0b0011, nosign)
    nosign = jnp.where(a <= 1.25, 0b0010, nosign)
    nosign = jnp.where(a < 0.75, 0b0001, nosign)
    nosign = jnp.where(a <= 0.25, 0b0000, nosign)
    return (sign << 3) | nosign


def pack_fp4(codes: Array) -> Array:
    """[..., N] int codes -> [..., N//2] uint8, even element in LOW nibble
    (utils.py:66-80 bit order)."""
    lo = codes[..., 0::2] & 0xF
    hi = codes[..., 1::2] & 0xF
    return (lo | (hi << 4)).astype(jnp.uint8)


def unpack_fp4(packed: Array) -> Array:
    """[..., P] uint8 -> [..., 2P] int32 codes (low nibble first)."""
    lo = (packed & 0xF).astype(jnp.int32)
    hi = (packed >> 4).astype(jnp.int32)
    return jnp.stack([lo, hi], axis=-1).reshape(*packed.shape[:-1], -1)


def quantize_mx(x: Array, dtype, compute_scale_method: str = "ocp"):
    """OCP MX quantization with 32-element blocks (utils.py:83-107).

    dtype: jnp.float8_e4m3fn, jnp.float8_e5m2, or the string 'fp4'.
    Returns (xq, scales): xq is fp8 [M, N] or packed fp4 uint8 [M, N//2];
    scales are E8M0 [M, N//32].
    """
    key = dtype if isinstance(dtype, str) else dtype
    x_blocks = x.astype(jnp.float32).reshape(*x.shape[:-1], -1, 32)
    blocks_amax = jnp.max(jnp.abs(x_blocks), axis=-1)

    if compute_scale_method == "ocp":
        scale_bits = absmax_to_mx_scales_ocp(blocks_amax, key)
    elif compute_scale_method == "nv":
        scale_bits = absmax_to_mx_scales_nv(blocks_amax, key)
    else:
        raise ValueError(f"unsupported {compute_scale_method=}")
    scales = jax.lax.bitcast_convert_type(
        scale_bits.astype(jnp.uint8), E8M0
    )

    dtype_amax = DTYPE_AMAX[key]
    scale_f32 = jax.lax.bitcast_convert_type(scale_bits << 23, jnp.float32)
    x_blocks = x_blocks / jnp.clip(scale_f32[..., None], min=1e-12)
    x_blocks = jnp.clip(x_blocks, -dtype_amax, dtype_amax)

    if key == "fp4":
        xq = pack_fp4(fp32_to_fp4e2m1(x_blocks).reshape(*x.shape[:-1], -1))
    else:
        xq = x_blocks.reshape(x.shape).astype(dtype)
    return xq, scales


def dequantize_mxfp4(xq: Array, scales: Array) -> Array:
    """packed fp4 uint8 [M, N//2] + E8M0 scales [M, N//32] -> fp32 [M, N]
    (utils.py:110-142)."""
    codes = unpack_fp4(xq)
    vals = FP4E2M1_LUT[codes]
    scale_bits = jax.lax.bitcast_convert_type(scales, jnp.uint8).astype(jnp.int32)
    scale_f32 = jax.lax.bitcast_convert_type(scale_bits << 23, jnp.float32)
    M = vals.shape[0]
    vals = vals.reshape(M, -1, 32) * scale_f32.reshape(M, -1, 1)
    return vals.reshape(M, -1)


def quantize_nvfp4(x: Array, tensor_scale: Array | None = None):
    """NVFP4: 16-element blocks, FP8-E4M3 block scales, fp32 tensor scale
    (utils.py:146-166). Returns (packed uint8 [M, N//2], scales e4m3
    [M, N//16], tensor_scale fp32)."""
    x_blocks = x.astype(jnp.float32).reshape(*x.shape[:-1], -1, 16)
    q_amax = DTYPE_AMAX["fp4"]
    s_amax = DTYPE_AMAX[F8E4M3]

    if tensor_scale is None:
        tensor_scale = jnp.max(jnp.abs(x_blocks)) / (q_amax * s_amax)

    blocks_amax = jnp.max(jnp.abs(x_blocks), axis=-1)
    scales_f32 = blocks_amax / jnp.clip(q_amax * tensor_scale, min=1e-12)
    scales = jnp.clip(scales_f32, -s_amax, s_amax).astype(F8E4M3)

    denom = jnp.clip(tensor_scale * scales.astype(jnp.float32), min=1e-12)
    x_blocks = x_blocks / denom[..., None]
    xq = pack_fp4(fp32_to_fp4e2m1(x_blocks).reshape(*x.shape[:-1], -1))
    return xq, scales, tensor_scale


def dequantize_nvfp4(xq: Array, scales: Array, tensor_scale: Array) -> Array:
    codes = unpack_fp4(xq)
    vals = FP4E2M1_LUT[codes]
    M = vals.shape[0]
    s = scales.astype(jnp.float32) * tensor_scale
    return (vals.reshape(M, -1, 16) * s.reshape(M, -1, 1)).reshape(M, -1)


def mxfp4_mm(
    a_packed: Array,
    b_t_packed: Array,
    scale_a: Array,
    scale_b: Array,
    bias: Array | None = None,
    *,
    out_dtype=jnp.bfloat16,
) -> Array:
    """MXFP4 block-scaled matmul (cutlass_sm120a_fp4.cu:42-136 contract).

    A [M, K//2] packed fp4, B.T [N, K//2] packed fp4 (the reference demands
    a row-major x column-major GEMM, cutlass_mm.py:80-86 — here B arrives
    pre-transposed like scaled_int4_mm), E8M0 scales per 32-element
    K-block: scale_a [M, K//32], scale_b [N, K//32]. Optional bias [N].

    There are no fp4 tensor cores on Hopper, so the op dequantizes to
    bf16 in the graph (LUT + E8M0 exponent scale, fused by XLA) and runs a
    bf16 GEMM. fp32 accumulation.
    """
    af = dequantize_mxfp4(a_packed, scale_a)  # [M, K] f32
    bf = dequantize_mxfp4(b_t_packed, scale_b)  # [N, K] f32
    out = jax.lax.dot_general(
        af.astype(jnp.bfloat16),
        bf.astype(jnp.bfloat16),
        (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    if bias is not None:
        out = out + bias.astype(jnp.float32)[None, :]
    return out.astype(out_dtype)


def nvfp4_mm(
    a_packed: Array,
    b_t_packed: Array,
    scale_a: Array,
    scale_b: Array,
    output_scale: Array,
    bias: Array | None = None,
    *,
    out_dtype=jnp.bfloat16,
) -> Array:
    """NVFP4 block-scaled matmul (cutlass_sm120a_fp4.cu:138-243 contract).

    16-element K-blocks with FP8-E4M3 scales (scale_a [M, K//16],
    scale_b [N, K//16]); ``output_scale`` is the scalar
    tensor_scale_a * tensor_scale_b folded into the epilogue
    (cutlass_mm.py:95-108). Optional bias [N] added AFTER output scaling,
    matching the reference epilogue order.
    """
    a_codes = FP4E2M1_LUT[unpack_fp4(a_packed)]
    b_codes = FP4E2M1_LUT[unpack_fp4(b_t_packed)]
    M, N = a_codes.shape[0], b_codes.shape[0]
    af = (a_codes.reshape(M, -1, 16) * scale_a.astype(jnp.float32)[..., None]).reshape(M, -1)
    bf = (b_codes.reshape(N, -1, 16) * scale_b.astype(jnp.float32)[..., None]).reshape(N, -1)
    out = jax.lax.dot_general(
        af.astype(jnp.bfloat16),
        bf.astype(jnp.bfloat16),
        (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    ) * output_scale.astype(jnp.float32)
    if bias is not None:
        out = out + bias.astype(jnp.float32)[None, :]
    return out.astype(out_dtype)


def pack_block_scales_nv(scales: Array) -> Array:
    """NVIDIA Blackwell 128x4 swizzled scale layout (utils.py:21-26) —
    contract parity for payload interop; flattened output."""
    M, N = scales.shape
    assert M % 128 == 0 and N % 4 == 0
    out = scales.reshape(M // 128, 128, N // 4, 4).transpose(0, 2, 1, 3)
    out = out.reshape(-1, 4, 32, 4).transpose(0, 2, 1, 3).reshape(-1, 32, 16)
    return out.reshape(-1)
