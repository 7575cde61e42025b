"""BitNet 1.58-bit quantized training.

Behavioral parity with subclasses/bitnet.py:
  - weight kept in bf16 (:class:`BitNetWeight`), ternarized {-1,0,1} with a
    tensor-wise abs-mean fp32 scale at every forward (bitnet.py:121-145)
  - activations dynamically quantized to row-wise INT8 with eps=1e-5
    (bitnet.py:134, the BitNet paper's Figure-3 recipe)
  - forward runs as an int8 GEMM with the scalar col-scale epilogue
    (triton_mm.py:211-215 COL_SCALE_SCALAR path)
  - backward: grad_input via mixed mm with the ternary weight; grad_weight
    from the QUANTIZED activation (bitnet.py:147-168)
  - the packed 2-bit form (:class:`BitNetPackedWeight`) is the quantized
    FSDP all-gather payload (bitnet.py:83-107, 206-311) — see
    parallel/fsdp.py for the shard_map collective.

Note the reference composes BitNet linears with a preceding RMSNorm by
module surgery (train_utils.py:47-71); this build does the same at the
model level (models/llama.py has a ``bitnet`` flag that inserts sub-norms).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..ops.scaled_mm import scaled_mm
from .core import (
    get_bitnet_scale,
    pack_i2_in_i8,
    quantize_bitnet_weight,
    quantize_int8,
    unpack_i2_in_i8,
)

Array = jax.Array


@partial(
    jax.tree_util.register_dataclass, data_fields=["data"], meta_fields=["mesh"]
)
@dataclass
class BitNetWeight:
    """bf16 master weight, ternarized on the fly every matmul.

    ``mesh`` (static metadata) routes the linear through the quantized
    2-bit FSDP all-gather when set with an fsdp axis > 1 — threaded
    explicitly by ``parallel.bitnet_fsdp_params`` rather than via global
    state, so a trace can never capture a stale mesh.
    """

    data: Array  # [out, in]
    mesh: object = None  # jax.sharding.Mesh | None (hashable, static)

    def __getstate__(self):
        # A jax Mesh holds Device objects, which cannot be pickled — and a
        # checkpoint must not bake runtime wiring anyway. Serialize with
        # mesh=None; parallel.bitnet_fsdp_params re-threads the live mesh
        # after load (llm_pretrain.py resume does this).
        return {"data": self.data, "mesh": None}

    def __setstate__(self, state):
        self.data = state["data"]
        self.mesh = state.get("mesh")

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self):
        return self.data.shape


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["packed", "scale"],
    meta_fields=[],
)
@dataclass
class BitNetPackedWeight:
    """2-bit packed ternary weight + scalar fp scale.

    The quantized FSDP all-gather payload (bitnet.py:206-263): 4 ternary
    values per int8, ``dequant = unpack(packed) * scale``.
    """

    packed: Array  # [out, in // 4] int8 (stacked: [L, out, in // 4])
    scale: Array  # scalar per weight matrix (stacked: [L])

    @classmethod
    def from_weight(cls, w: Array, scale: Array | None = None):
        if scale is None:
            # per-matrix abs-mean; for scan-stacked [L, out, in] weights
            # one scalar per layer
            scale = jnp.mean(
                jnp.abs(w.astype(jnp.float32)), axis=(-2, -1)
            )
        w_i8 = quantize_bitnet_weight(w, scale[..., None, None]) if w.ndim == 3 else quantize_bitnet_weight(w, scale)
        return cls(pack_i2_in_i8(w_i8), scale.astype(w.dtype))

    def dequantize(self, dtype=None) -> Array:
        out = unpack_i2_in_i8(self.packed).astype(self.scale.dtype) * self.scale[
            ..., None, None
        ]
        return out.astype(dtype) if dtype is not None else out

    @property
    def shape(self):
        return self.packed.shape[:-1] + (self.packed.shape[-1] * 4,)


@jax.custom_vjp
def _bitnet_linear(x2d: Array, w: Array, key: Array):
    out, _ = _bitnet_fwd_impl(x2d, w, key)
    return out


def _bitnet_fwd_impl(x2d, w, key):
    # BitNet training recipe (bitnet.py:128-145)
    x_i8, row_scale = quantize_int8(x2d, axis=-1, eps=1e-5)
    tensor_scale = get_bitnet_scale(w)  # fp32
    w_i8 = quantize_bitnet_weight(w, tensor_scale)
    tensor_scale = tensor_scale.astype(w.dtype)
    out = scaled_mm(x_i8, w_i8.T, row_scale, tensor_scale, out_dtype=x2d.dtype)
    return out, (x_i8, row_scale, w_i8, tensor_scale)


def _bitnet_linear_fwd(x2d, w, key):
    out, res = _bitnet_fwd_impl(x2d, w, key)
    return out, res


def _bitnet_linear_bwd(res, g):
    x_i8, row_scale, w_i8, tensor_scale = res
    g = g.astype(tensor_scale.dtype)
    # mixed mm + scalar scale (bitnet.py:158-161)
    grad_input = (g @ w_i8.astype(g.dtype)) * tensor_scale
    # grad from the QUANTIZED activation (bitnet.py:163-165)
    grad_weight = g.T @ (x_i8.astype(g.dtype) * row_scale)
    return grad_input, grad_weight, None


_bitnet_linear.defvjp(_bitnet_linear_fwd, _bitnet_linear_bwd)


def linear(
    x: Array,
    w: BitNetWeight | BitNetPackedWeight,
    bias: Array | None = None,
    *,
    key: Array | None = None,
) -> Array:
    if key is None:
        key = jax.random.PRNGKey(0)
    batch_dims = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])

    if isinstance(w, BitNetPackedWeight):
        out = _bitnet_packed_linear(x2d, w.packed, w.scale)
        out_features = w.shape[0]
    else:
        mesh = w.mesh
        if mesh is not None and mesh.shape.get("fsdp", 1) > 1:
            from ..parallel import fsdp as _fsdp

            # quantized 2-bit FSDP all-gather path (bitnet.py:83-107)
            out = _fsdp.bitnet_fsdp_linear(x2d, w.data, mesh)
        else:
            out = _bitnet_linear(x2d, w.data, key)
        out_features = w.data.shape[0]

    out = out.reshape(*batch_dims, out_features)
    if bias is not None:
        out = out + bias
    return out


@jax.custom_vjp
def _bitnet_packed_linear(x2d: Array, packed: Array, scale: Array):
    """Forward with a pre-quantized 2-bit weight (bitnet.py:266-286)."""
    x_i8, row_scale = quantize_int8(x2d, axis=-1, eps=1e-5)
    w_i8 = unpack_i2_in_i8(packed)
    return scaled_mm(x_i8, w_i8.T, row_scale, scale, out_dtype=x2d.dtype)


def _bitnet_packed_linear_fwd(x2d, packed, scale):
    x_i8, row_scale = quantize_int8(x2d, axis=-1, eps=1e-5)
    w_i8 = unpack_i2_in_i8(packed)
    out = scaled_mm(x_i8, w_i8.T, row_scale, scale, out_dtype=x2d.dtype)
    return out, (x_i8, row_scale, packed, scale)


def _bitnet_packed_linear_bwd(res, g):
    x_i8, row_scale, packed, scale = res
    w_i8 = unpack_i2_in_i8(packed)
    g = g.astype(scale.dtype)
    grad_input = (g @ w_i8.astype(g.dtype)) * scale
    grad_weight = g.T @ (x_i8.astype(g.dtype) * row_scale)
    return grad_input, None, jnp.zeros_like(scale)


_bitnet_packed_linear.defvjp(_bitnet_packed_linear_fwd, _bitnet_packed_linear_bwd)
