"""Mesh-collective bandwidth microbenchmark (benchmark_nccl.py analog).

The reference measures NCCL all-reduce GiB/s under torchrun
(`benchmark_nccl.py:10-36`); the equivalent here measures XLA
collectives (psum / all_gather / psum_scatter, handed to NCCL) over a
mesh of every GPU of the process. Needs at least two GPUs.

Usage:
  python benchmark_collectives.py [--axis data] [--size_mb 64]
"""

from __future__ import annotations

import argparse
import json


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--axis", default="data")
    parser.add_argument("--size_mb", type=float, default=64.0)
    parser.add_argument("--n_iters", type=int, default=20)
    args = parser.parse_args()

    from quantized_training_tpu.parallel import benchmark_collectives, make_mesh
    from quantized_training_tpu.utils.runtime import (
        gpu_name_and_power_limit, require_gpu, setup_compile_cache,
    )

    info = require_gpu()
    setup_compile_cache()
    if info["count"] < 2:
        raise SystemExit(f"only {info['count']} GPU; collective benchmarks need >= 2")
    mesh = make_mesh({args.axis: info["count"]})
    print(f"{gpu_name_and_power_limit()}; {info}, axis={args.axis!r}")
    results = benchmark_collectives(
        mesh, axis=args.axis, size_mb=args.size_mb, n_iters=args.n_iters
    )
    print(json.dumps({k: round(v, 2) for k, v in results.items()}))


if __name__ == "__main__":
    main()
