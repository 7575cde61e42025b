"""AdamW with BF16 optimizer states + stochastic-rounding writeback.

Behavioral parity with other_optim/bf16_sr.py:
  1. optimizer states always BF16 (bf16_sr.py:50-52)
  2. all math in FP32 (bf16_sr.py:94-106)
  3. BF16 params are written back with stochastic rounding via the
     int32 add-random-16-bits-then-truncate trick (bf16_sr.py:108-122)

Design: a functional optimizer — ``step(grads, state, params, lr, key) ->
(new_params, new_state)`` — fused into the jitted train step (the
reference needed a per-param torch.compile; here XLA fuses the whole tree
update, and the SR bits come from ``jax.random``).

Works on any float pytree, including scheme wrappers (MixedPrecisionWeight
etc.) since those are transparent pytrees of float leaves.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..quant.core import bf16_stochastic_round

Array = jax.Array


class Optimizer(NamedTuple):
    """Functional optimizer: params-in, params-out (the reference mutates
    in place; this is the jit-friendly equivalent)."""

    init: Callable[[Any], Any]
    step: Callable[..., tuple[Any, Any]]  # (grads, state, params, lr, key)


class AdamWState(NamedTuple):
    count: Array  # scalar int32
    exp_avg: Any  # bf16 tree
    exp_avg_sq: Any  # bf16 tree


def adamw_bf16_sr(
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 1e-2,
    bf16_stochastic_rounding: bool = True,
) -> Optimizer:
    b1, b2 = betas

    def init(params):
        zeros = lambda t: jax.tree.map(
            lambda p: jnp.zeros(p.shape, jnp.bfloat16), t
        )
        return AdamWState(jnp.zeros((), jnp.int32), zeros(params), zeros(params))

    def step(grads, state: AdamWState, params, lr, key=None):
        count = state.count + 1
        t = count.astype(jnp.float32)
        bc1 = 1.0 - b1**t
        bc2 = 1.0 - b2**t
        lr = jnp.asarray(lr, jnp.float32)

        flat_g, treedef = jax.tree_util.tree_flatten(grads)
        flat_p = treedef.flatten_up_to(params)
        flat_ea = treedef.flatten_up_to(state.exp_avg)
        flat_eas = treedef.flatten_up_to(state.exp_avg_sq)

        new_p, new_ea, new_eas = [], [], []
        for i, (g, p, ea, eas) in enumerate(
            zip(flat_g, flat_p, flat_ea, flat_eas)
        ):
            g32 = g.astype(jnp.float32)
            ea32 = ea.astype(jnp.float32) + (1 - b1) * (g32 - ea.astype(jnp.float32))
            eas32 = eas.astype(jnp.float32) + (1 - b2) * (
                jnp.square(g32) - eas.astype(jnp.float32)
            )
            denom = jnp.sqrt(eas32) / jnp.sqrt(bc2) + eps
            numer = ea32 / bc1
            p32 = p.astype(jnp.float32)
            upd = p32 - lr * weight_decay * p32 - lr * numer / denom

            if p.dtype == jnp.bfloat16 and bf16_stochastic_rounding:
                if key is None:
                    raise ValueError("bf16 SR writeback requires a PRNG key")
                k = jax.random.fold_in(jax.random.fold_in(key, i), count)
                new_p.append(bf16_stochastic_round(upd, k))
            else:
                new_p.append(upd.astype(p.dtype))
            new_ea.append(ea32.astype(jnp.bfloat16))
            new_eas.append(eas32.astype(jnp.bfloat16))

        unflat = lambda leaves: jax.tree_util.tree_unflatten(treedef, leaves)
        return unflat(new_p), AdamWState(count, unflat(new_ea), unflat(new_eas))

    return Optimizer(init, step)


def adamw(
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 1e-2,
) -> Optimizer:
    """Plain fp32-state AdamW (the torch.optim.AdamW baseline path)."""

    def init(params):
        zeros = lambda t: jax.tree.map(
            lambda p: jnp.zeros(p.shape, jnp.float32), t
        )
        return AdamWState(jnp.zeros((), jnp.int32), zeros(params), zeros(params))

    b1, b2 = betas

    def step(grads, state: AdamWState, params, lr, key=None):
        del key
        count = state.count + 1
        t = count.astype(jnp.float32)
        bc1 = 1.0 - b1**t
        bc2 = 1.0 - b2**t
        lr = jnp.asarray(lr, jnp.float32)

        def upd(g, p, ea, eas):
            g32 = g.astype(jnp.float32)
            ea = ea + (1 - b1) * (g32 - ea)
            eas = eas + (1 - b2) * (jnp.square(g32) - eas)
            denom = jnp.sqrt(eas) / jnp.sqrt(bc2) + eps
            p32 = p.astype(jnp.float32)
            new_p = p32 - lr * weight_decay * p32 - lr * (ea / bc1) / denom
            return new_p.astype(p.dtype), ea, eas

        out = jax.tree.map(upd, grads, params, state.exp_avg, state.exp_avg_sq)
        leaves, treedef = jax.tree_util.tree_flatten(
            out, is_leaf=lambda x: isinstance(x, tuple)
        )
        unzip = lambda j: jax.tree_util.tree_unflatten(
            treedef, [l[j] for l in leaves]
        )
        return unzip(0), AdamWState(count, unzip(1), unzip(2))

    return Optimizer(init, step)
