"""Quantized FSDP all-gather for BitNet — the reference's marquee
distributed feature, rebuilt as a shard_map collective.

Reference behavior (subclasses/bitnet.py:83-107):
  - fsdp_pre_all_gather: compute the LOCAL shard's abs-mean scale,
    all-reduce it with AVG across the group (:85), ternarize the shard with
    the GLOBAL scale, pack to 2 bits/value (:88-89)
  - FSDP all-gathers the 2-bit payload (8x less traffic than bf16) plus
    the scalar scale as metadata
  - fsdp_post_all_gather reconstructs a packed-2-bit weight whose linear
    runs on int8 tensor cores (:92-107)
  - grads are reduce-scattered back to the shards (FSDP2 framework-side)

Design: one ``custom_vjp`` wrapping quantize -> all_gather ->
int8 matmul, executed per-device inside ``shard_map`` over the
(data, fsdp) mesh:
  fwd:  pmean(scale, 'fsdp') -> ternarize+pack local shard ->
        all_gather(int8-packed payload, 'fsdp') over ICI -> unpack ->
        scaled_mm with the scalar col scale
  bwd:  grad_input local; grad_weight = psum_scatter over 'fsdp'
        (combines the gradient sum over fsdp batch rows with the weight
        scatter in one collective) + psum over 'data'

Because every shard has the same number of elements, the mean-of-shard-
means equals the global abs-mean — bitwise the same ternarization as the
single-device path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.scaled_mm import scaled_mm
from ..quant.core import (
    pack_i2_in_i8,
    quantize_int8,
    unpack_i2_in_i8,
)

Array = jax.Array

def bitnet_fsdp_params(params, mesh: Mesh | None):
    """Thread ``mesh`` into every BitNetWeight wrapper (static metadata),
    routing their linears through the quantized 2-bit all-gather.

    Replaces the old mutable module-global context: the mesh rides the
    param pytree itself, so a cached trace can never capture a stale one.
    Pass ``mesh=None`` to restore single-device routing.
    """
    from ..quant.bitnet import BitNetWeight

    active = mesh if mesh is not None and mesh.shape.get("fsdp", 1) > 1 else None
    return jax.tree.map(
        lambda x: BitNetWeight(x.data, active) if isinstance(x, BitNetWeight) else x,
        params,
        is_leaf=lambda x: isinstance(x, BitNetWeight),
    )


@jax.custom_vjp
def _bitnet_fsdp_linear_local(x2d: Array, w_local: Array):
    out, _ = _fwd_impl(x2d, w_local)
    return out


def _fwd_impl(x2d, w_local):
    # global abs-mean via mean of equal-size shard means (bitnet.py:84-85)
    scale = jnp.mean(jnp.abs(w_local.astype(jnp.float32)))
    scale = jax.lax.pmean(scale, "fsdp")
    w_i8_local = jnp.clip(
        jnp.round(w_local.astype(jnp.float32) / jnp.clip(scale, min=1e-5)), -1, 1
    ).astype(jnp.int8)
    w_i2_local = pack_i2_in_i8(w_i8_local)  # [out_shard, in//4]
    # the 8x-smaller payload rides ICI (bitnet.py:88-89 + FSDP gather)
    w_i2_full = jax.lax.all_gather(w_i2_local, "fsdp", axis=0, tiled=True)

    x_i8, row_scale = quantize_int8(x2d, axis=-1, eps=1e-5)
    w_i8_full = unpack_i2_in_i8(w_i2_full)
    scale_cast = scale.astype(x2d.dtype)
    out = scaled_mm(x_i8, w_i8_full.T, row_scale, scale_cast, out_dtype=x2d.dtype)
    return out, (x_i8, row_scale, w_i2_full, scale_cast)


def _fwd(x2d, w_local):
    out, res = _fwd_impl(x2d, w_local)
    return out, res


def _bwd(res, g):
    x_i8, row_scale, w_i2_full, scale = res
    w_i8_full = unpack_i2_in_i8(w_i2_full)
    g = g.astype(scale.dtype)
    # bitnet.py:158-165 formulas, on local batch rows
    grad_input = (g @ w_i8_full.astype(g.dtype)) * scale
    grad_w_full = g.T @ (x_i8.astype(g.dtype) * row_scale)
    # sum over fsdp batch shards + scatter weight rows in one collective,
    # then complete the data-parallel sum
    grad_w_local = jax.lax.psum_scatter(
        grad_w_full, "fsdp", scatter_dimension=0, tiled=True
    )
    grad_w_local = jax.lax.psum(grad_w_local, "data")
    return grad_input, grad_w_local


_bitnet_fsdp_linear_local.defvjp(_fwd, _bwd)


def bitnet_fsdp_linear(x: Array, w: Array, mesh: Mesh) -> Array:
    """x [..., in] (batch sharded over data x fsdp) @ ternarized w.T with a
    quantized 2-bit all-gather of the fsdp-sharded weight [out, in]."""
    batch_dims = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])

    f = jax.shard_map(
        _bitnet_fsdp_linear_local,
        mesh=mesh,
        in_specs=(P(("data", "fsdp"), None), P("fsdp", None)),
        out_specs=P(("data", "fsdp"), None),
    )
    out = f(x2d, w)
    return out.reshape(*batch_dims, w.shape[0])
