"""INT8 conv2d ops (triton_conv2d.py analog).

Contracts (kernels/gn_kernels/triton_conv2d.py:150-214, :385-396):
  - ``int8_conv2d(X, W, stride, padding)``: int8 x int8 -> int32
  - ``scaled_int8_conv2d(X, W, channel_scale, stride, padding)``: fused
    per-output-channel fp scale epilogue -> bf16
  - ``conv2d``: generic (bf16/fp32) with fp32 accumulation

Layout: NHWC activations and HWIO weights — "channels-last" (the
reference demands channels_last for the same reason,
triton_conv2d.py:209-213).

cuDNN offers XLA no s8 x s8 -> s32 convolution (XLA widens the operands
to s32, which cuDNN refuses), so int8 convs run on bf16 operands (exact
for int8 values) with fp32 accumulation. A sum of at most 1024 int8
products stays within 2^24, where fp32 holds every integer, so the input
channels are split into groups of kh*kw*c <= 1024 terms, each group's
conv is exact, and the groups are summed in int32.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

Array = jax.Array

_DN = ("NHWC", "HWIO", "NHWC")
_EXACT_TERMS = 1024  # 1024 * 128^2 = 2^24


def _norm2(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(
    x: Array,
    w: Array,
    stride: int | tuple[int, int] = 1,
    padding: int | tuple[int, int] = 0,
) -> Array:
    """Generic conv with fp32 accumulation; int8 inputs give exact int32."""
    stride, padding = _norm2(stride), _norm2(padding)
    conv = partial(
        jax.lax.conv_general_dilated,
        window_strides=stride,
        padding=[(padding[0], padding[0]), (padding[1], padding[1])],
        dimension_numbers=_DN,
        preferred_element_type=jnp.float32,
    )
    if x.dtype != jnp.int8:
        return conv(x, w).astype(x.dtype)
    kh, kw, cin, _ = w.shape
    group = _EXACT_TERMS // (kh * kw)
    assert group >= 1, f"a {kh}x{kw} kernel sums more than {_EXACT_TERMS} terms per channel"
    x, w = x.astype(jnp.bfloat16), w.astype(jnp.bfloat16)
    out = None
    for c in range(0, cin, group):
        part = conv(x[..., c : c + group], w[:, :, c : c + group]).astype(jnp.int32)
        out = part if out is None else out + part
    return out


def int8_conv2d(
    x: Array,
    w: Array,
    stride: int | tuple[int, int] = 1,
    padding: int | tuple[int, int] = 0,
) -> Array:
    """x [B,H,W,C] int8, w [kh,kw,C,O] int8 -> int32 [B,OH,OW,O]."""
    assert x.dtype == jnp.int8 and w.dtype == jnp.int8
    return conv2d(x, w, stride, padding)


def scaled_int8_conv2d(
    x: Array,
    w: Array,
    channel_scale: Array,
    stride: int | tuple[int, int] = 1,
    padding: int | tuple[int, int] = 0,
    *,
    out_dtype=jnp.bfloat16,
) -> Array:
    """INT8 conv with a fused per-output-channel scale epilogue
    (triton_conv2d.py:316-319)."""
    assert x.dtype == jnp.int8 and w.dtype == jnp.int8
    acc = conv2d(x, w, stride, padding)
    return (
        acc.astype(jnp.float32) * channel_scale.astype(jnp.float32).reshape(1, 1, 1, -1)
    ).astype(out_dtype)
