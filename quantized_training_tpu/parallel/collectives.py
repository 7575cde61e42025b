"""Collective micro-benchmarks over the mesh (benchmark_nccl.py analog).

The reference measures NCCL all-reduce GiB/s under torchrun
(benchmark_nccl.py:10-36); here the same measurement runs over the mesh's
devices via shard_map collectives (NCCL on GPUs). It measures whatever
devices the mesh holds; ``benchmark_collectives.py`` refuses a non-GPU
mesh. The repeat loop runs DEVICE-SIDE
(fori_loop chained through the data) so host dispatch stays out of the
numbers.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def _timed(fn, *args) -> float:
    out = fn(*args)
    jax.tree.leaves(out)[0].block_until_ready()
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0


def benchmark_collectives(
    mesh: Mesh,
    axis: str = "data",
    size_mb: float = 64.0,
    n_iters: int = 20,
) -> dict[str, float]:
    """Returns GiB/s for psum (all-reduce), all_gather, psum_scatter."""
    n_dev = mesh.shape[axis]
    if n_dev < 2:
        raise ValueError(f"axis {axis!r} has size {n_dev}; need >= 2")
    n_elems = int(size_mb * 1e6 / 4)
    n_elems -= n_elems % (n_dev * 128)
    x = jnp.arange(n_elems, dtype=jnp.float32).reshape(n_dev, -1) * 1e-9

    results = {}

    def run(name, local_fn, in_spec, bytes_moved):
        @jax.jit
        def f(x):
            def body(i, acc):
                return local_fn(acc) * 0.5 + acc * 0.5  # chain iterations
            return jax.shard_map(
                lambda xs: jax.lax.fori_loop(0, n_iters, body, xs),
                mesh=mesh,
                in_specs=in_spec,
                out_specs=in_spec,
            )(x)

        dt = _timed(f, x)
        results[name] = bytes_moved * n_iters / dt / 2**30

    full_bytes = n_elems * 4
    # all-reduce moves ~2x(n-1)/n of the buffer per device (ring)
    run(
        "psum_GiBps",
        lambda v: jax.lax.psum(v, axis) / n_dev,
        P(axis, None),
        full_bytes * 2 * (n_dev - 1) / n_dev,
    )
    run(
        "all_gather_GiBps",
        lambda v: jax.lax.all_gather(v, axis, axis=0, tiled=True)
        .reshape(n_dev, -1)
        .mean(0, keepdims=True)
        .repeat(v.shape[0], 0),
        P(axis, None),
        full_bytes * (n_dev - 1) / n_dev,
    )
    run(
        "psum_scatter_GiBps",
        lambda v: jnp.tile(
            jax.lax.psum_scatter(v, axis, scatter_dimension=1, tiled=True)
            / n_dev,
            (1, n_dev),
        ),
        P(axis, None),
        full_bytes * (n_dev - 1) / n_dev,
    )
    return results
