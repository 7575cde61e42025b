"""Block-wise 8-bit quantized optimizer state.

Capability parity with the torchao ``OptimState8bit`` used by
AdamWScheduleFree8bit (other_optim/schedule_free_adamw.py:7,106-111):
optimizer state stored as one byte per element with a per-256-element-block
fp32 scale, dequantized for the fp32 update math and re-quantized after.

This implementation uses the same dynamic (cube-law) code layout idea as
8-bit optimizers — a monotone nonlinear 256-entry codebook gives more
resolution near zero where second-moment values cluster — realized here as
a signed/unsigned cubic codebook (x -> x**3 spacing), which is simple,
branch-free, and invertible via searchsorted.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

BLOCK = 256


def _make_codebook(signed: bool) -> np.ndarray:
    if signed:
        grid = np.linspace(-1.0, 1.0, 256, dtype=np.float64)
    else:
        grid = np.linspace(0.0, 1.0, 256, dtype=np.float64)
    return np.sign(grid) * np.abs(grid) ** 3  # cubic: dense near 0


_CODEBOOK_SIGNED = jnp.asarray(_make_codebook(True), jnp.float32)
_CODEBOOK_UNSIGNED = jnp.asarray(_make_codebook(False), jnp.float32)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["codes", "scale"],
    meta_fields=["shape", "signed"],
)
@dataclass
class OptimState8bit:
    codes: Array  # [n] uint8
    scale: Array  # [n // BLOCK] fp32 per-block absmax
    shape: tuple = ()
    signed: bool = False

    @classmethod
    def zeros(cls, shape, signed: bool = False):
        n = int(np.prod(shape))
        assert n % BLOCK == 0, f"size {n} not a multiple of {BLOCK}"
        return cls(
            jnp.zeros((n,), jnp.uint8),
            jnp.zeros((n // BLOCK,), jnp.float32),
            tuple(shape),
            signed,
        )

    def _codebook(self) -> Array:
        return _CODEBOOK_SIGNED if self.signed else _CODEBOOK_UNSIGNED

    def dequantize(self) -> Array:
        vals = self._codebook()[self.codes]
        vals = vals.reshape(-1, BLOCK) * self.scale[:, None]
        return vals.reshape(self.shape)

    def requantize(self, x: Array) -> "OptimState8bit":
        xf = x.astype(jnp.float32).reshape(-1, BLOCK)
        scale = jnp.max(jnp.abs(xf), axis=-1)
        normed = xf / jnp.clip(scale, min=1e-30)[:, None]
        cb = self._codebook()
        # nearest codebook entry: searchsorted on the monotone codebook,
        # then pick the closer of the two neighbors
        idx = jnp.clip(jnp.searchsorted(cb, normed.reshape(-1)), 1, 255)
        lo, hi = cb[idx - 1], cb[idx]
        pick_hi = (normed.reshape(-1) - lo) > (hi - normed.reshape(-1))
        codes = jnp.where(pick_hi, idx, idx - 1).astype(jnp.uint8)
        return OptimState8bit(codes, scale, self.shape, self.signed)
