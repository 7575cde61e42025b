"""Tensor-parallel inference sharding over the 'model' mesh axis.

The reference has no tensor parallelism (SURVEY §2.3); this is the
An extension for serving: Megatron-style weight sharding where
the attention/MLP *expansion* matmuls shard their output dim and the
*contraction* matmuls (o_proj, down_proj) shard their input dim, so the
only collectives XLA must insert are one psum after o_proj and one after
down_proj per layer — riding ICI. The KV cache shards over its head dim,
and the lm_head over vocab.

Everything here is declarative: we only hand `jax.jit`/`device_put` the
`NamedSharding`s and let the SPMD partitioner place the collectives —
the idiomatic JAX way (no hand-written all-reduce).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# per-layer linear kernels are stacked [L, out, in]
_OUT_SHARDED = {"q", "k", "v", "gate", "up"}  # column-parallel
_IN_SHARDED = {"o", "down"}  # row-parallel (psum after)


def _path_keys(path) -> list[str]:
    return [getattr(p, "key", None) for p in path]


def tp_param_spec(path, leaf, mesh: Mesh) -> P:
    """PartitionSpec for one param leaf under tensor parallelism."""
    n = mesh.shape["model"]
    if n == 1:
        return P()
    keys = _path_keys(path)

    def ok(dim: int) -> bool:
        return leaf.ndim > dim and leaf.shape[dim] % n == 0

    if "lm_head" in keys and ok(0):
        return P("model")  # vocab-sharded logits
    if any(k in _OUT_SHARDED for k in keys) and leaf.ndim == 3 and ok(1):
        return P(None, "model", None)
    if any(k in _IN_SHARDED for k in keys) and leaf.ndim == 3 and ok(2):
        return P(None, None, "model")
    return P()  # embeddings, norms, odd shapes: replicated


def shard_params_tp(params, mesh: Mesh):
    """device_put a param tree with TP shardings (wrapper-transparent:
    quantized weight pytrees shard their array leaves by the same rule
    as the wrapping path)."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    placed = [
        jax.device_put(leaf, NamedSharding(mesh, tp_param_spec(path, leaf, mesh)))
        for path, leaf in flat
    ]
    return jax.tree_util.tree_unflatten(treedef, placed)


def kv_cache_spec(mesh: Mesh, num_kv_heads: int | None = None) -> P:
    """KVCache arrays are [L, B, S, KV_heads, hd]: shard the head dim.

    Falls back to replication when the head count doesn't divide the
    model axis (mirrors tp_param_spec's divisibility guard — better a
    replicated cache than a sharding error deep inside device_put)."""
    n = mesh.shape["model"]
    if n == 1 or (num_kv_heads is not None and num_kv_heads % n != 0):
        return P()
    return P(None, None, None, "model", None)


def shard_kv_cache(cache, mesh: Mesh):
    def put(x):
        spec = kv_cache_spec(mesh, num_kv_heads=x.shape[3] if x.ndim == 5 else None)
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, cache)
