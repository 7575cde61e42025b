"""INT8 quantized-training scheme: int8 weight STORAGE + optional dynamic
activation quantization.

Behavioral parity with subclasses/int8.py:
  - weight stored as (int8 data, per-row scale); forward uses the int data
    directly (mixed bf16 matmul for 'none', int8 scaled_mm for
    'int8'/'int8_sr') — int8.py:138-161
  - backward is always bf16-dominant: grad_input via mixed mm with the int
    weight, grad_weight = g.T @ x in bf16 (int8.py:164-180; the scale lies
    along the reduction dim so int8 backward is not possible here)
  - the optimizer dequantizes, updates in fp32, and re-quantizes with
    stochastic rounding (int8.py:104-133) — realized here by the
    master/storage split in quant/api.py: the train step dequantizes the
    storage into a differentiable fp "master", grads flow to the master, and
    the updated master is re-quantized (SR) into storage each step.

Design: :class:`Int8Weight` is a pytree whose ``master`` slot
carries the differentiable dequantized weight during a train step (None in
storage form); the linear is a ``custom_vjp`` routing the weight cotangent
to the master.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..ops.scaled_mm import scaled_mm
from .configs import Int8QTConfig
from .core import dequantize_int8, quantize_int8

Array = jax.Array


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["int_data", "scale", "master"],
    meta_fields=["config"],
)
@dataclass
class Int8Weight:
    """INT8-stored linear weight: ``dequant = int_data * scale``.

    ``master`` is None in storage form; during a train step it holds the
    differentiable dequantized weight (see quant/api.py).
    """

    int_data: Array  # [out, in] int8
    scale: Array  # [out, 1] same float dtype as the original weight
    master: Array | None = None
    config: Int8QTConfig = Int8QTConfig()

    @classmethod
    def from_float(cls, w: Array, config: Int8QTConfig = Int8QTConfig()):
        int_data, scale = quantize_int8(w, axis=-1)
        return cls(int_data, scale, None, config)

    def dequantize(self) -> Array:
        return dequantize_int8(self.int_data, self.scale)

    @property
    def dtype(self):
        return self.scale.dtype

    @property
    def shape(self):
        return self.int_data.shape


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _int8_qt_linear(config: Int8QTConfig, x2d, master, int_data, scale, key):
    """Forward-only quantized compute; ``master`` exists to carry the grad."""
    del master
    if config.activation == "none":
        # weight-only: mixed matmul, int8 weight upcast in-matmul
        # (int8.py:144-147)
        return (x2d @ int_data.T.astype(x2d.dtype)) * scale.reshape(1, -1)
    sr = config.activation == "int8_sr"
    x_i8, x_scale = quantize_int8(x2d, axis=-1, stochastic_rounding=sr, key=key)
    # int8 matmul with the row x col scale epilogue (int8.py:149-158)
    return scaled_mm(x_i8, int_data.T, x_scale, scale.reshape(1, -1), out_dtype=x2d.dtype)


def _int8_qt_linear_fwd(config, x2d, master, int_data, scale, key):
    out = _int8_qt_linear(config, x2d, master, int_data, scale, key)
    return out, (x2d, int_data, scale)


def _int8_qt_linear_bwd(config, res, g):
    x2d, int_data, scale = res
    g = g.astype(scale.dtype)
    # grad_input via mixed mm with the int8 weight (int8.py:170)
    grad_input = (g * scale.reshape(1, -1)) @ int_data.astype(g.dtype)
    # grad_weight in bf16 (int8.py:177) — routed to the master slot
    grad_master = g.T @ x2d
    return grad_input, grad_master, None, jnp.zeros_like(scale), None


_int8_qt_linear.defvjp(_int8_qt_linear_fwd, _int8_qt_linear_bwd)


def linear(
    x: Array,
    w: Int8Weight,
    bias: Array | None = None,
    *,
    key: Array | None = None,
) -> Array:
    if key is None:
        if w.config.activation == "int8_sr":
            raise ValueError("activation='int8_sr' requires a PRNG key")
        key = jax.random.PRNGKey(0)
    batch_dims = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    master = w.master if w.master is not None else w.dequantize()
    out = _int8_qt_linear(w.config, x2d, master, w.int_data, w.scale, key)
    out = out.reshape(*batch_dims, w.int_data.shape[0])
    if bias is not None:
        out = out + bias
    return out
