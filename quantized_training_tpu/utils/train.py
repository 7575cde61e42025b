"""Training utilities: LR schedule, grad norm, model stats.

Parity: LRSchedule warmup/hold/decay (train_utils.py:84-120), grad-norm
(train_utils.py:21-26 — the DTensor .full_tensor() concern disappears
here: jit output is already global).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


class LRSchedule:
    """warmup -> hold -> {linear|cosine} decay, fractions of n_steps
    (train_utils.py:84-120)."""

    def __init__(
        self,
        lr: float,
        n_steps: int,
        warmup: float = 0.0,
        decay: float = 0.0,
        decay_type: str = "linear",
    ) -> None:
        self.lr = lr
        self.t1 = int(n_steps * warmup)
        self.t2 = int(n_steps * (1 - decay))
        self.t3 = n_steps
        self.decay_type = decay_type
        assert self.t1 <= self.t2
        assert decay_type in ("linear", "cosine")

    def get_lr(self, step: int) -> float:
        if step < self.t1:
            return self.lr * step / self.t1
        if step < self.t2:
            return self.lr
        if step < self.t3:
            progress = (step - self.t2) / (self.t3 - self.t2)
            if self.decay_type == "linear":
                return self.lr * (1 - progress)
            return 0.5 * self.lr * (1 + math.cos(progress * math.pi))
        return 0.0


def global_norm(tree) -> jax.Array:
    """sqrt of the sum of squared leaves (train_utils.py:21-26)."""
    leaves = jax.tree.leaves(tree)
    return jnp.sqrt(
        sum(jnp.sum(jnp.square(l.astype(jnp.float32))) for l in leaves)
    )


def clip_by_global_norm(tree, max_norm: float):
    """Returns (clipped_tree, pre-clip norm) — torch.nn.utils.clip_grad_norm_
    semantics (llm_pretrain.py:201-206)."""
    norm = global_norm(tree)
    factor = jnp.minimum(1.0, max_norm / jnp.maximum(norm, 1e-12))
    return jax.tree.map(lambda g: (g * factor).astype(g.dtype), tree), norm


def print_model_stats(params) -> None:
    n = int(sum(np.prod(l.shape) for l in jax.tree.leaves(params)))
    print(f"No. of params: {n:,}")
