"""User-facing quantization API.

Replaces the reference's tensor-subclass dispatch (``__torch_function__``
F.linear intercepts + optimizer ``__torch_dispatch__`` tables) with explicit
functional equivalents:

  - :func:`qlinear` — type-dispatched linear (the F.linear intercept)
  - :func:`quantize_params` — tree transform wrapping linear weights in
    scheme pytrees (the ``convert_*`` family, train_utils.py:35-75)
  - :func:`virtual_params` / :func:`merge_masters` / :func:`commit_params` —
    the quantized-STORAGE training contract: each step dequantizes storage
    into a differentiable fp "master" tree, grads/optimizer act on masters,
    and the updated masters are re-quantized into storage with stochastic
    rounding (the semantics of aten.copy_/addcdiv_ handling in
    subclasses/int8.py:104-133 and subclasses/int4.py:107-142).

Schemes whose storage is already float (mixed_precision, bitnet) pass
through all three transforms unchanged — their wrappers are transparent
float pytrees that optimizers update leaf-wise.
"""

from __future__ import annotations

from dataclasses import replace

import jax

from . import bitnet as _bitnet
from . import int4 as _int4
from . import int8 as _int8
from . import mixed_precision as _mp
from .configs import Int8QTConfig, MixedPrecisionConfig
from .core import quantize_int8

Array = jax.Array

# storage-quantized schemes: optimizer works on a dequantized master
STORAGE_QUANTIZED_TYPES = (_int8.Int8Weight, _int4.Int4Weight)
# all weight wrapper types
QUANT_TYPES = (
    _int8.Int8Weight,
    _int4.Int4Weight,
    _bitnet.BitNetWeight,
    _bitnet.BitNetPackedWeight,
    _mp.MixedPrecisionWeight,
    _mp.PreQuantMPWeight,
)


def is_quant_weight(x) -> bool:
    return isinstance(x, QUANT_TYPES)


def prequantize_step(params, key: Array | None = None):
    """Hoist per-matmul weight quantization out of the layer loop.

    Maps every int8 :class:`mixed_precision.MixedPrecisionWeight` in the
    tree to a :class:`mixed_precision.PreQuantMPWeight` whose row/col int8
    views are computed ONCE — call this at the top of a training-step
    forward (models/llama.py::backbone does). Weights are constant within
    a step, so the dynamic scheme's per-matmul re-quantization (fwd
    rowwise, fwd-again under remat, bwd colwise) collapses into one fused
    both-axis pass per weight; gradients still flow to the bf16 master.
    Other wrapper types and plain arrays pass through unchanged.

    ``QT_PREQUANT`` env var (read at trace time): 'both' pre-quantizes
    both axes, 'row'/'col' just one, '0' (DEFAULT) disables — per-matmul
    dynamic quantization. Materializing both int8 views costs 2 bytes per
    weight element of device memory for the step; whether the saved
    quantize passes pay for that is not measured on the GPU.
    """
    import os

    mode = os.environ.get("QT_PREQUANT", "0")
    if mode == "0":
        return params
    mode = {"1": "both"}.get(mode, mode)
    leaves, treedef = jax.tree_util.tree_flatten(
        params, is_leaf=is_quant_weight
    )
    out = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, _mp.MixedPrecisionWeight):
            k = None if key is None else jax.random.fold_in(key, i)
            leaf = _mp.prequantize_weight(leaf, k, mode=mode)
        out.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, out)


def qlinear(x: Array, w, bias: Array | None = None, *, key: Array | None = None):
    """y = x @ w.T + bias, dispatched on the weight wrapper type."""
    if isinstance(w, (_mp.MixedPrecisionWeight, _mp.PreQuantMPWeight)):
        return _mp.linear(x, w, bias, key=key)
    if isinstance(w, _int8.Int8Weight):
        return _int8.linear(x, w, bias, key=key)
    if isinstance(w, _int4.Int4Weight):
        return _int4.linear(x, w, bias, key=key)
    if isinstance(w, (_bitnet.BitNetWeight, _bitnet.BitNetPackedWeight)):
        return _bitnet.linear(x, w, bias, key=key)
    out = x @ w.T
    return out + bias if bias is not None else out


def qlinear_multi(x: Array, weights, *, key: Array | None = None):
    """[y_i = x @ w_i.T] for several heads sharing one input.

    For mixed-precision all-int8 weights the shared input is dynamically
    quantized ONCE for all heads (and once in the backward) —
    quant/mixed_precision.py::linear_shared; other schemes fall back to
    independent :func:`qlinear` calls (per-head subkeys)."""
    if all(
        isinstance(w, (_mp.MixedPrecisionWeight, _mp.PreQuantMPWeight))
        for w in weights
    ):
        return _mp.linear_shared(x, weights, key=key)
    return [
        qlinear(
            x, w,
            key=None if key is None else jax.random.fold_in(key, i),
        )
        for i, w in enumerate(weights)
    ]


def _is_linear_weight_path(path) -> bool:
    """True for leaves stored under a dict key named 'w'.

    Model convention (models/): every linear kernel is ``{"w": [O, I]}``.
    This predicate does NOT exclude the lm_head — callers compose their own
    policy on top (e.g. llm_pretrain's --quantize_lm_head flag); only the
    DEFAULT filter of :func:`quantize_params` excludes it.
    """
    if not path:
        return False
    last = path[-1]
    key = getattr(last, "key", None)
    return key == "w"


def _default_filter(path, leaf) -> bool:
    """Linear 'w' leaves except the LM head: the reference quantizes only
    the transformer body — ``model.model`` — so the lm_head (and the tied
    embedding) stay full precision (llm_pretrain.py:122,
    train_utils.py:36-39).

    Also skips small or oddly shaped linears (any matmul dim < 128 or not
    a multiple of 32, e.g. ViT classifier heads [45, D] or [1000, D]):
    the quantize passes cost more than an int8 GEMM of that size can
    save, and int8 tensor-core GEMMs want dims that are multiples of 16.
    """
    if any(getattr(p, "key", None) == "lm_head" for p in path):
        return False
    if not _is_linear_weight_path(path):
        return False
    return all(d >= 128 and d % 32 == 0 for d in leaf.shape[-2:])


def quantize_params(
    params,
    scheme: str | None,
    *,
    filter_fn=None,
    **kwargs,
):
    """Wrap linear weights of ``params`` in scheme pytrees.

    ``scheme``: one of 'mixed_precision', 'int8_quantized_training',
    'int4_weight_only', 'bitnet', or None (no-op) — string dispatch parity
    with train_utils.quantize_model (train_utils.py:35-75).
    ``kwargs`` feed the scheme config (the --quantize_kwargs JSON contract).
    """
    if scheme is None:
        return params
    filter_fn = filter_fn or _default_filter

    if scheme == "mixed_precision":
        config = MixedPrecisionConfig(**kwargs)
        wrap = lambda w: _mp.MixedPrecisionWeight(w, config)
    elif scheme == "int8_quantized_training":
        config = Int8QTConfig(**kwargs)
        wrap = lambda w: _int8.Int8Weight.from_float(w, config)
    elif scheme == "int4_weight_only":
        group_size = kwargs.pop("group_size", 32)
        assert not kwargs, f"unexpected kwargs {kwargs}"
        wrap = lambda w: _int4.Int4Weight.from_float(w, group_size)
    elif scheme == "bitnet":
        assert not kwargs, f"unexpected kwargs {kwargs}"
        wrap = lambda w: _bitnet.BitNetWeight(w)
    else:
        raise ValueError(f"unknown quantization scheme {scheme!r}")

    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    new_leaves = [
        wrap(leaf) if filter_fn(path, leaf) else leaf for path, leaf in leaves
    ]
    return jax.tree_util.tree_unflatten(treedef, new_leaves)


def _map_quant(fn_quant, fn_other, tree):
    return jax.tree.map(
        lambda x: fn_quant(x) if is_quant_weight(x) else fn_other(x),
        tree,
        is_leaf=is_quant_weight,
    )


def virtual_params(qparams):
    """Storage tree -> differentiable float tree (masters for quantized
    storage, identity elsewhere)."""
    return _map_quant(
        lambda q: q.dequantize() if isinstance(q, STORAGE_QUANTIZED_TYPES) else q,
        lambda x: x,
        qparams,
    )


def merge_masters(vparams, qparams):
    """Pair the differentiable masters back with their quantized storage so
    the forward can use the int data while grads flow to the master."""
    leaves_q, treedef = jax.tree_util.tree_flatten(qparams, is_leaf=is_quant_weight)
    leaves_v = treedef.flatten_up_to(vparams)
    merged = [
        replace(q, master=v) if isinstance(q, STORAGE_QUANTIZED_TYPES) else v
        for v, q in zip(leaves_v, leaves_q)
    ]
    return jax.tree_util.tree_unflatten(treedef, merged)


def commit_params(new_vparams, qparams, key: Array):
    """Updated masters -> new storage tree, re-quantizing with SR.

    One PRNG subkey per quantized leaf (deterministic: fold_in on leaf
    index).
    """
    leaves_v, treedef = jax.tree_util.tree_flatten(
        new_vparams, is_leaf=is_quant_weight
    )
    leaves_q = treedef.flatten_up_to(qparams)

    out = []
    for i, (v, q) in enumerate(zip(leaves_v, leaves_q)):
        if isinstance(q, _int8.Int8Weight):
            k = jax.random.fold_in(key, i)
            int_data, scale = quantize_int8(
                v, axis=-1, stochastic_rounding=True, key=k
            )
            out.append(_int8.Int8Weight(int_data, scale, None, q.config))
        elif isinstance(q, _int4.Int4Weight):
            k = jax.random.fold_in(key, i)
            out.append(_int4.requantize(v, q, k))
        else:
            out.append(v)
    return jax.tree_util.tree_unflatten(treedef, out)
