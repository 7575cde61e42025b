"""Device mesh + sharding rules (the DDP/FSDP2/NCCL replacement).

The reference distributes with torchrun + NCCL: DDP gradient all-reduce
(llm_pretrain.py:126-132) and FSDP2 per-layer param sharding
(llm_pretrain.py:134-139). Equivalent here: ONE logical mesh with
axes

  - 'data': pure data parallelism — batch sharded, params replicated;
    XLA inserts the gradient psum (the DDP analog)
  - 'fsdp': ZeRO-3 — params/optimizer state sharded on a weight dim,
    batch sharded; XLA inserts per-layer all-gather (params) and
    reduce-scatter (grads) around the scanned layer body (the FSDP2
    analog, with the latency-hiding scheduler overlapping the collectives)
  - 'model': tensor parallelism for inference (not in the reference)

Sharding rule for parameter leaves (scan-stacked [L, out, in] and their
quantized-wrapper children): shard the second dimension over 'fsdp'
(per-layer output-dim shard = FSDP2's dim-0 shard per layer); 2D leaves
(embedding, lm_head) shard dim 0; everything else replicates. Leaves whose
dim is not divisible by the axis replicate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXES = ("data", "fsdp", "model")


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """axes e.g. {"data": 2, "fsdp": 4}; missing axes get size 1."""
    devices = devices if devices is not None else jax.devices()
    axes = dict(axes or {})
    sizes = [int(axes.get(a, 1)) for a in AXES]
    n = int(np.prod(sizes))
    if n > len(devices):
        raise ValueError(f"mesh {axes} needs {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(sizes)
    return Mesh(dev, AXES)


def batch_spec(mesh: Mesh, ndim: int) -> P:
    """Batch axis sharded over data x fsdp (both are data-parallel for
    activations); supports [B, S] and [accum, B, S]."""
    ax = tuple(a for a in ("data", "fsdp") if mesh.shape[a] > 1) or None
    if ndim == 3:
        return P(None, ax, None)
    return P(ax, None)


def shard_batch(batch, mesh: Mesh):
    """Host batch -> device-sharded global batch.

    Single-process: a plain device_put with the batch spec. Multi-process
    (``jax.distributed``): each process passes its LOCAL slice of the
    global batch (the loaders' ``process_index``/``process_count``
    sharding contract) and the global array is assembled from the local
    slices — the multi-host path of llm_pretrain.py:126-132's DDP setup.
    """
    if jax.process_count() > 1:
        return tuple(
            jax.make_array_from_process_local_data(
                NamedSharding(mesh, batch_spec(mesh, x.ndim)), np.asarray(x)
            )
            for x in batch
        )
    return tuple(
        jax.device_put(
            jnp.asarray(x), NamedSharding(mesh, batch_spec(mesh, x.ndim))
        )
        for x in batch
    )


def param_spec(leaf, mesh: Mesh) -> P:
    """FSDP sharding spec for one array leaf (see module docstring)."""
    n_fsdp = mesh.shape["fsdp"]
    if n_fsdp == 1 or leaf.ndim == 0:
        return P()
    if leaf.ndim >= 3:  # stacked [L, out, ...]
        if leaf.shape[1] % n_fsdp == 0:
            return P(None, "fsdp")
        if leaf.shape[2] % n_fsdp == 0:
            return P(None, None, "fsdp")
        return P()
    if leaf.ndim == 2:  # embedding / lm_head [V, D]
        if leaf.shape[0] % n_fsdp == 0:
            return P("fsdp")
        return P()
    if leaf.ndim == 1 and leaf.shape[0] % n_fsdp == 0:
        return P("fsdp")
    return P()


def state_shardings(state, mesh: Mesh):
    """NamedSharding tree for a TrainState/param tree: every array leaf gets
    the FSDP param rule; scalars replicate."""
    return jax.tree.map(
        lambda l: NamedSharding(mesh, param_spec(l, mesh)), state
    )


def shard_state(state, mesh: Mesh):
    return jax.device_put(state, state_shardings(state, mesh))
