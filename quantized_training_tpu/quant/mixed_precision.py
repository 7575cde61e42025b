"""Mixed-precision (INT8/INT4) dynamic quantized training — flagship scheme.

Behavioral parity with subclasses/mixed_precision.py: the forward matmul and
both backward matmuls (grad_input, grad_weight) are INDEPENDENTLY toggled to
run as dynamic row-wise-quantized INT8 (or INT4) matmuls, re-quantizing both
operands per matmul (which is what makes the backward quantizable at all —
the scale never lies along the reduction dim, mixed_precision.py:100-134).

Design: the weight stays a plain bf16 array inside a
:class:`MixedPrecisionWeight` pytree wrapper; the linear is a
``jax.custom_vjp`` whose bwd issues the same scaled-matmul kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..ops.scaled_mm import scaled_mm, scaled_mm_general
from ..ops.int4_mm import scaled_int4_mm
from .configs import MixedPrecisionConfig
from .core import quantize_int8, quantize_int8_both, quantize_int4_rowwise_absmax

Array = jax.Array


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["config"],
)
@dataclass
class MixedPrecisionWeight:
    """bf16 master weight + static per-matmul quantization config.

    Pytree analog of MixedPrecisionLinearWeight (mixed_precision.py:23-97):
    the wrapper only tags the weight with its config; all quantization is
    dynamic, per matmul.
    """

    data: Array  # [out, in] (or [L, out, in] when stacked for scan)
    config: MixedPrecisionConfig

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self):
        return self.data.shape


def _dynamic_int8_mm(
    a: Array,
    b: Array,
    sr: bool,
    key: Array | None,
    dims: tuple[int, int] = (1, 0),
) -> Array:
    """Contract a over dims[0] and b over dims[1], both operands
    dynamically quantized to INT8 along their contraction axis so the
    scales stay off the reduction dim (mixed_precision.py:100-108).

    Explicit contraction dims keep every call transpose-free: the caller
    never materializes ``x.T`` / ``w.T``; XLA picks the GEMM layout.
    """
    ka = kb = None
    if sr:
        ka, kb = jax.random.split(key)
    a_i8, sa = quantize_int8(a, axis=dims[0], stochastic_rounding=sr, key=ka)
    b_i8, sb = quantize_int8(b, axis=dims[1], stochastic_rounding=sr, key=kb)
    return scaled_mm_general(a_i8, b_i8, sa, sb, dims=dims, out_dtype=a.dtype)


def _dynamic_int4_mm(a: Array, b: Array) -> Array:
    """INT4 variant (no SR in the reference either, mixed_precision.py:126-134)."""
    a_i4, row_scale = quantize_int4_rowwise_absmax(a)
    b_t_i4, col_scale = quantize_int4_rowwise_absmax(b.T)
    return scaled_int4_mm(a_i4, b_t_i4, row_scale, col_scale, out_dtype=a.dtype)


def _dynamic_fp8_mm(
    a: Array, b: Array, scale_mode: str, dims: tuple[int, int]
) -> Array:
    """Dynamic FP8 (e4m3) matmul, row- or tile-scaled (BASELINE config #3).

    ``row``: both operands quantized with absmax row scales along the
    contraction axis (transpose-free, like the int8 path).
    ``tile``: DeepSeek-V3 layout — A gets 1x128 group scales along K, B
    128x128 block scales — through ``scaled_mm``'s tile branch. The tile
    branch takes standard [M,K] @ [K,N] operands, so non-standard
    contraction dims transpose the BF16 inputs first. The fp8 operands
    are upcast to bf16 for the dot (ops/scaled_mm.py).
    """
    from ..ops.fp8 import quantize_fp8, quantize_fp8_block, quantize_fp8_tile

    K = a.shape[dims[0]]
    N = b.shape[1 - dims[1]]
    # tile mode needs K and N to be 128-multiples (128-wide groups /
    # 128x128 blocks); shapes that aren't — e.g. a sub-128 token count in
    # grad_weight, where the token dim IS the contraction — degrade to
    # row scaling for that matmul (static shape branch)
    if scale_mode == "tile" and K % 128 == 0 and N % 128 == 0:
        a_std = a if dims[0] == 1 else a.T
        b_std = b if dims[1] == 0 else b.T
        a_q, a_s = quantize_fp8_tile(a_std)
        b_q, b_s = quantize_fp8_block(b_std)
        return scaled_mm(a_q, b_q, a_s, b_s, out_dtype=a.dtype)

    a_q, a_s = quantize_fp8(a, axis=dims[0])
    b_q, b_s = quantize_fp8(b, axis=dims[1])
    return scaled_mm_general(a_q, b_q, a_s, b_s, dims=dims, out_dtype=a.dtype)


def _dynamic_mm(
    a: Array,
    b: Array,
    config: MixedPrecisionConfig,
    key,
    dims: tuple[int, int] = (1, 0),
) -> Array:
    if config.dtype == "int8":
        return _dynamic_int8_mm(a, b, config.stochastic_rounding, key, dims)
    elif config.dtype == "int4":
        a = a if dims[0] == 1 else a.T
        b = b if dims[1] == 0 else b.T
        return _dynamic_int4_mm(a, b)
    elif config.dtype == "fp8_e4m3":
        return _dynamic_fp8_mm(a, b, config.scale, dims)
    raise ValueError(f"unsupported mixed-precision dtype {config.dtype!r}")


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _mp_linear(config: MixedPrecisionConfig, x2d: Array, w: Array, key: Array):
    """x2d [B, in] @ w.T [in, out]; w is [out, in]."""
    if config.output:
        # contract x2d dim 1 with w dim 1 — w is used as-is ([out, in])
        return _dynamic_mm(x2d, w, config, _subkey(key, 0), dims=(1, 1))
    return x2d @ w.T


def _subkey(key: Array, i: int) -> Array:
    return jax.random.fold_in(key, i)


def _all_int8(config: MixedPrecisionConfig) -> bool:
    return (
        config.dtype == "int8"
        and config.output
        and config.grad_input
        and config.grad_weight
    )


def _mp_linear_fwd(config, x2d, w, key):
    # NOTE: when the loss is differentiated, THIS function (not the
    # primal `_mp_linear`) runs in the forward pass — so it must not do
    # any backward-only work (e.g. the colwise quantizes of x and w).
    return _mp_linear(config, x2d, w, key), (x2d, w, key)


def _mp_linear_bwd(config, res, g):
    x2d, w, key = res
    g = g.astype(w.dtype)

    if config.grad_input and config.grad_weight and config.dtype == "int8":
        # both backward matmuls INT8: g is needed quantized along BOTH
        # axes (rowwise for grad_input, colwise for grad_weight)
        sr = config.stochastic_rounding
        kg = kw = kx = None
        if sr:
            kg, kw, kx = jax.random.split(_subkey(key, 1), 3)
        g_row, g_row_s, g_col, g_col_s = quantize_int8_both(
            g, stochastic_rounding=sr, key=kg
        )
        w_col, w_col_s = quantize_int8(w, axis=0, stochastic_rounding=sr, key=kw)
        x_col, x_col_s = quantize_int8(x2d, axis=0, stochastic_rounding=sr, key=kx)
        grad_input = scaled_mm_general(
            g_row, w_col, g_row_s, w_col_s, dims=(1, 0), out_dtype=w.dtype
        )
        # grad_w = g.T @ x expressed transpose-free: contract BOTH over
        # the token dim with g as the LHS, so the result comes out
        # [out, in] directly (no .T copy of the [in, out] product)
        grad_weight = scaled_mm_general(
            g_col, x_col, g_col_s, x_col_s, dims=(0, 0), out_dtype=w.dtype
        )
        return grad_input, grad_weight, None

    if config.grad_input:
        grad_input = _dynamic_mm(g, w, config, _subkey(key, 1), dims=(1, 0))
    else:
        grad_input = g @ w

    if config.grad_weight:
        # grad_w = g.T @ x2d: contract BOTH operands over the token dim
        # (axis 0), each quantized along it (the per-matmul re-quantization
        # of mixed_precision.py:183-188), with g as LHS so the product is
        # [out, in] with no materialized transpose
        grad_weight = _dynamic_mm(g, x2d, config, _subkey(key, 2), dims=(0, 0))
    else:
        grad_weight = g.T @ x2d

    return grad_input, grad_weight, None  # key gets no cotangent


_mp_linear.defvjp(_mp_linear_fwd, _mp_linear_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _mp_linear_shared(config: MixedPrecisionConfig, x2d: Array, ws, key: Array):
    """Shared-input multi-linear: y_i = x2d @ ws[i].T with ONE dynamic
    quantization of x2d for all heads (all-int8 config only; the caller
    guarantees it): q/k/v (and gate/up) share one quantize of the hidden
    state, in the forward and in the backward's colwise pass."""
    sr = config.stochastic_rounding
    kx = _subkey(key, 0) if sr else None
    x_row, x_row_s = quantize_int8(x2d, axis=1, stochastic_rounding=sr, key=kx)
    outs = []
    for i, w in enumerate(ws):
        kw = jax.random.fold_in(_subkey(key, 1), i) if sr else None
        w_row, w_row_s = quantize_int8(w, axis=1, stochastic_rounding=sr, key=kw)
        outs.append(
            scaled_mm_general(
                x_row, w_row, x_row_s, w_row_s, dims=(1, 1), out_dtype=x2d.dtype
            )
        )
    return tuple(outs)


def _mp_linear_shared_fwd(config, x2d, ws, key):
    return _mp_linear_shared(config, x2d, ws, key), (x2d, ws, key)


def _mp_linear_shared_bwd(config, res, gs):
    x2d, ws, key = res
    sr = config.stochastic_rounding
    kx = jax.random.fold_in(_subkey(key, 2), 0) if sr else None
    # ONE colwise quantize of the shared input serves every grad_weight
    x_col, x_col_s = quantize_int8(x2d, axis=0, stochastic_rounding=sr, key=kx)
    grad_input = None
    grad_ws = []
    for i, (w, g) in enumerate(zip(ws, gs)):
        g = g.astype(w.dtype)
        kg = kw = None
        if sr:
            kg, kw = jax.random.split(jax.random.fold_in(_subkey(key, 3), i))
        g_row, g_row_s, g_col, g_col_s = quantize_int8_both(
            g, stochastic_rounding=sr, key=kg
        )
        w_col, w_col_s = quantize_int8(w, axis=0, stochastic_rounding=sr, key=kw)
        gi = scaled_mm_general(
            g_row, w_col, g_row_s, w_col_s, dims=(1, 0), out_dtype=w.dtype
        )
        grad_input = gi if grad_input is None else grad_input + gi
        grad_ws.append(
            scaled_mm_general(
                g_col, x_col, g_col_s, x_col_s, dims=(0, 0), out_dtype=w.dtype
            )
        )
    return grad_input, tuple(grad_ws), None


_mp_linear_shared.defvjp(_mp_linear_shared_fwd, _mp_linear_shared_bwd)


def linear_shared(
    x: Array,
    weights,
    *,
    key: Array | None = None,
):
    """[y_i = x @ w_i.T] with the shared input quantized once.

    ``weights``: list of MixedPrecisionWeight with IDENTICAL all-int8
    config. Falls back to per-weight :func:`linear` otherwise.
    """
    configs = {w.config for w in weights}
    cfg = next(iter(configs))
    preq = all(isinstance(w, PreQuantMPWeight) for w in weights)
    if len(configs) != 1 or not _all_int8(cfg) or not (
        preq or all(isinstance(w, MixedPrecisionWeight) for w in weights)
    ):
        return [linear(x, w, key=key) for w in weights]
    if key is None:
        if cfg.stochastic_rounding:
            raise ValueError("stochastic_rounding requires a PRNG key")
        key = jax.random.PRNGKey(0)
    batch_dims = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if preq:
        outs = _mp_linear_shared_pq(
            cfg, x2d,
            tuple(w.orig for w in weights),
            tuple(w.row_q for w in weights),
            tuple(w.row_s for w in weights),
            tuple(w.col_q for w in weights),
            tuple(w.col_s for w in weights),
            key,
        )
        return [
            o.reshape(*batch_dims, w.orig.shape[0]) for o, w in zip(outs, weights)
        ]
    outs = _mp_linear_shared(cfg, x2d, tuple(w.data for w in weights), key)
    return [o.reshape(*batch_dims, w.data.shape[0]) for o, w in zip(outs, weights)]


def linear(
    x: Array,
    w,
    bias: Array | None = None,
    *,
    key: Array | None = None,
) -> Array:
    """Mixed-precision linear: y = x @ w.T + bias with per-matmul quant.

    Accepts a :class:`MixedPrecisionWeight` (dynamic per-matmul weight
    quantization) or a :class:`PreQuantMPWeight` (per-step pre-quantized
    weight views, see :func:`prequantize_weight`)."""
    if key is None:
        if w.config.stochastic_rounding:
            raise ValueError("stochastic_rounding requires a PRNG key")
        key = jax.random.PRNGKey(0)
    batch_dims = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if isinstance(w, PreQuantMPWeight):
        out_features = w.orig.shape[0]
        out = _mp_linear_pq(
            w.config, x2d, w.orig, w.row_q, w.row_s, w.col_q, w.col_s, key
        )
    else:
        out_features = w.data.shape[0]
        out = _mp_linear(w.config, x2d, w.data, key)
    out = out.reshape(*batch_dims, out_features)
    if bias is not None:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# Per-step weight pre-quantization (VERDICT r3 item 1a)
#
# Weights are CONSTANT within a training step, yet the dynamic scheme
# re-quantizes every w per matmul: rowwise in the forward (and AGAIN in the
# remat recompute of the forward inside the backward), colwise in the
# backward for grad_input. Pre-quantizing each weight once per step
# removes all three passes; the quantized views ride the scan as saved inputs, so remat
# never recomputes them. Numerics are IDENTICAL to the dynamic path: the
# same absmax quantize of the same bf16 weight, just hoisted out of the
# layer loop (reference semantics: subclasses/mixed_precision.py:100-134
# quantizes per matmul, but the produced int tensors are equal for equal
# inputs; with SR the rounding draw is per-step instead of per-matmul —
# still unbiased).
# ---------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["orig", "row_q", "row_s", "col_q", "col_s"],
    meta_fields=["config"],
)
@dataclass
class PreQuantMPWeight:
    """Step-scoped pre-quantized views of a mixed-precision weight.

    orig:  bf16 master [*, out, in] — the gradient target (never read by
           the forward when the matmul is int8)
    row_q: int8 quantized along `in`  (forward operand), [*, out, in]
    col_q: int8 quantized along `out` (grad_input operand), [*, out, in]
    Unused views (config toggles) are 0-sized placeholders.
    """

    orig: Array
    row_q: Array
    row_s: Array
    col_q: Array
    col_s: Array
    config: MixedPrecisionConfig

    @property
    def dtype(self):
        return self.orig.dtype

    @property
    def shape(self):
        return self.orig.shape


def _placeholder(w: Array):
    z = jnp.zeros(w.shape[:-2] + (0, 0), jnp.int8)
    s = jnp.zeros(w.shape[:-2] + (0, 0), w.dtype)
    return z, s


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _prequant(need_row: bool, need_col: bool, sr: bool, w: Array, key: Array):
    """w -> (w, row_q, row_s, col_q, col_s); grad flows only to w."""
    return _prequant_impl(need_row, need_col, sr, w, key)


def _prequant_impl(need_row, need_col, sr, w, key):
    stacked = w.ndim == 3

    def q_both(wi, ki):
        return quantize_int8_both(wi, stochastic_rounding=sr, key=ki)

    def q_axis(axis):
        def f(wi, ki):
            return quantize_int8(wi, axis=axis, stochastic_rounding=sr, key=ki)

        return f

    if sr:
        keys = (
            jax.vmap(lambda i: jax.random.fold_in(key, i))(
                jnp.arange(w.shape[0])
            )
            if stacked
            else key
        )
    else:
        keys = (
            jnp.zeros((w.shape[0], 2), jnp.uint32) if stacked else None
        )

    def run(f):
        # stacked [L, out, in] weights: vmap the 2D quantize over the
        # layer axis
        if stacked:
            return jax.vmap(f)(w, keys)
        return f(w, keys)

    if need_row and need_col:
        row_q, row_s, col_q, col_s = run(q_both)
    elif need_row:
        row_q, row_s = run(q_axis(-1))
        col_q, col_s = _placeholder(w)
    else:
        col_q, col_s = run(q_axis(-2))
        row_q, row_s = _placeholder(w)
    return w, row_q, row_s, col_q, col_s


def _prequant_fwd(need_row, need_col, sr, w, key):
    return _prequant_impl(need_row, need_col, sr, w, key), None


def _prequant_bwd(need_row, need_col, sr, _res, ct):
    # grad_weight lands on the pack's `orig` slot (the linears' bwd puts
    # it there); cotangents on the quantized views are zero by design
    return ct[0], None


_prequant.defvjp(_prequant_fwd, _prequant_bwd)


def prequantize_weight(
    w: MixedPrecisionWeight, key: Array | None = None, mode: str = "both"
):
    """MixedPrecisionWeight -> PreQuantMPWeight (int8 configs only).

    No-op (returns ``w`` unchanged) for configs the pre-quantized linear
    does not cover: non-int8 dtypes, and configs where neither the
    forward nor grad_input matmul is quantized. ``mode`` restricts which
    views are precomputed ('both' | 'row' | 'col'); the linear falls back
    to dynamic quantization for a missing view."""
    cfg = w.config
    if cfg.dtype != "int8":
        return w
    need_row = cfg.output and mode in ("both", "row")
    need_col = cfg.grad_input and mode in ("both", "col")
    if not (need_row or need_col):
        return w
    if key is None:
        if cfg.stochastic_rounding:
            raise ValueError("stochastic_rounding requires a PRNG key")
        key = jax.random.PRNGKey(0)
    pack = _prequant(need_row, need_col, cfg.stochastic_rounding, w.data, key)
    return PreQuantMPWeight(*pack, config=cfg)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _mp_linear_pq(config, x2d, w, row_q, row_s, col_q, col_s, key):
    """x2d [B, in] @ pre-quantized w.T; w [out, in] is the grad target.

    A 0-sized row/col view (mode-restricted prequantization) falls back
    to dynamic quantization of ``w`` for that matmul — a static (shape)
    branch, resolved at trace time."""
    if config.output:
        sr = config.stochastic_rounding
        kx = _subkey(key, 0) if sr else None
        x_row, x_row_s = quantize_int8(x2d, axis=1, stochastic_rounding=sr, key=kx)
        if row_q.size == 0:
            kw = _subkey(key, 4) if sr else None
            row_q, row_s = quantize_int8(
                w, axis=1, stochastic_rounding=sr, key=kw
            )
        return scaled_mm_general(
            x_row, row_q, x_row_s, row_s, dims=(1, 1), out_dtype=x2d.dtype
        )
    return x2d @ w.T


def _mp_linear_pq_fwd(config, x2d, w, row_q, row_s, col_q, col_s, key):
    out = _mp_linear_pq(config, x2d, w, row_q, row_s, col_q, col_s, key)
    return out, (x2d, w, col_q, col_s, key)


def _mp_linear_pq_bwd(config, res, g):
    x2d, w, col_q, col_s, key = res
    g = g.astype(x2d.dtype)
    sr = config.stochastic_rounding

    if config.grad_input and col_q.size == 0:
        # mode-restricted prequantization: col view not precomputed
        kw = _subkey(key, 5) if sr else None
        col_q, col_s = quantize_int8(w, axis=0, stochastic_rounding=sr, key=kw)

    if config.grad_input and config.grad_weight:
        kg = kx = None
        if sr:
            kg, kx = jax.random.split(_subkey(key, 1))
        g_row, g_row_s, g_col, g_col_s = quantize_int8_both(
            g, stochastic_rounding=sr, key=kg
        )
        x_col, x_col_s = quantize_int8(x2d, axis=0, stochastic_rounding=sr, key=kx)
        grad_input = scaled_mm_general(
            g_row, col_q, g_row_s, col_s, dims=(1, 0), out_dtype=w.dtype
        )
        grad_weight = scaled_mm_general(
            g_col, x_col, g_col_s, x_col_s, dims=(0, 0), out_dtype=w.dtype
        )
        return grad_input, grad_weight, None, None, None, None, None

    if config.grad_input:
        kg = _subkey(key, 1) if sr else None
        g_row, g_row_s = quantize_int8(g, axis=1, stochastic_rounding=sr, key=kg)
        grad_input = scaled_mm_general(
            g_row, col_q, g_row_s, col_s, dims=(1, 0), out_dtype=w.dtype
        )
    else:
        grad_input = g @ w

    if config.grad_weight:
        kg = kx = None
        if sr:
            kg, kx = jax.random.split(_subkey(key, 2))
        g_col, g_col_s = quantize_int8(g, axis=0, stochastic_rounding=sr, key=kg)
        x_col, x_col_s = quantize_int8(x2d, axis=0, stochastic_rounding=sr, key=kx)
        grad_weight = scaled_mm_general(
            g_col, x_col, g_col_s, x_col_s, dims=(0, 0), out_dtype=w.dtype
        )
    else:
        grad_weight = g.T @ x2d

    return grad_input, grad_weight, None, None, None, None, None


_mp_linear_pq.defvjp(_mp_linear_pq_fwd, _mp_linear_pq_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _mp_linear_shared_pq(config, x2d, ws, row_qs, row_ss, col_qs, col_ss, key):
    """Shared-input multi-linear over pre-quantized weights: ONE dynamic
    quantization of x2d serves every head (all-int8 config only)."""
    sr = config.stochastic_rounding
    kx = _subkey(key, 0) if sr else None
    x_row, x_row_s = quantize_int8(x2d, axis=1, stochastic_rounding=sr, key=kx)
    outs = []
    for i, (w, rq, rs) in enumerate(zip(ws, row_qs, row_ss)):
        if rq.size == 0:  # mode-restricted: quantize dynamically
            kw = jax.random.fold_in(_subkey(key, 4), i) if sr else None
            rq, rs = quantize_int8(w, axis=1, stochastic_rounding=sr, key=kw)
        outs.append(
            scaled_mm_general(
                x_row, rq, x_row_s, rs, dims=(1, 1), out_dtype=x2d.dtype
            )
        )
    return tuple(outs)


def _mp_linear_shared_pq_fwd(config, x2d, ws, row_qs, row_ss, col_qs, col_ss, key):
    out = _mp_linear_shared_pq(config, x2d, ws, row_qs, row_ss, col_qs, col_ss, key)
    return out, (x2d, ws, col_qs, col_ss, key)


def _mp_linear_shared_pq_bwd(config, res, gs):
    x2d, ws, col_qs, col_ss, key = res
    sr = config.stochastic_rounding
    kx = jax.random.fold_in(_subkey(key, 2), 0) if sr else None
    # ONE colwise quantize of the shared input serves every grad_weight
    x_col, x_col_s = quantize_int8(x2d, axis=0, stochastic_rounding=sr, key=kx)
    grad_input = None
    grad_ws = []
    for i, (cq, cs, g) in enumerate(zip(col_qs, col_ss, gs)):
        if cq.size == 0:  # mode-restricted: quantize dynamically
            kw = jax.random.fold_in(_subkey(key, 5), i) if sr else None
            cq, cs = quantize_int8(
                ws[i], axis=0, stochastic_rounding=sr, key=kw
            )
        g = g.astype(x2d.dtype)
        kg = _subkey(jax.random.fold_in(_subkey(key, 3), i), 0) if sr else None
        g_row, g_row_s, g_col, g_col_s = quantize_int8_both(
            g, stochastic_rounding=sr, key=kg
        )
        gi = scaled_mm_general(
            g_row, cq, g_row_s, cs, dims=(1, 0), out_dtype=ws[i].dtype
        )
        grad_input = gi if grad_input is None else grad_input + gi
        grad_ws.append(
            scaled_mm_general(
                g_col, x_col, g_col_s, x_col_s, dims=(0, 0), out_dtype=ws[i].dtype
            )
        )
    n = len(grad_ws)
    return (
        grad_input,
        tuple(grad_ws),
        (None,) * n,
        (None,) * n,
        (None,) * n,
        (None,) * n,
        None,
    )


_mp_linear_shared_pq.defvjp(_mp_linear_shared_pq_fwd, _mp_linear_shared_pq_bwd)
