"""Conv2d benchmark: INT8 vs BF16 over ResNet/VAE shapes
(benchmark_conv2d.py analog — speedup table, :29-48)."""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp

from quantized_training_tpu.ops import conv as conv_ops

# (batch, H, W, C_in, C_out, kernel, stride) — ResNet/VAE-style shapes
SHAPES = [
    (32, 56, 56, 64, 64, 3, 1),
    (32, 56, 56, 64, 128, 3, 2),
    (32, 28, 28, 128, 256, 3, 2),
    (32, 14, 14, 256, 512, 3, 2),
    (8, 128, 128, 128, 128, 3, 1),  # VAE-ish
    (8, 64, 64, 256, 256, 3, 1),
]


def time_fn(fn, *args, n=30):
    out = fn(*args)
    jax.block_until_ready(out)

    @jax.jit
    def many(*a):
        def body(i, carry):
            o = fn(*a)
            s = jnp.sum(o.astype(jnp.float32) * 1e-9)
            return carry + s

        return jax.lax.fori_loop(0, n, body, jnp.zeros((), jnp.float32))

    acc = many(*args)
    _ = float(acc)
    t0 = time.perf_counter()
    _ = float(many(*args))
    return (time.perf_counter() - t0) / n


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args()

    from quantized_training_tpu.utils.runtime import (
        gpu_name_and_power_limit, require_gpu, setup_compile_cache,
    )

    require_gpu()
    setup_compile_cache()
    shapes = SHAPES[:3] if args.quick else SHAPES
    print(f"device: {gpu_name_and_power_limit()}")
    print("| B,H,W,Cin->Cout k s | bf16 ms | int8 ms | speedup |")
    print("|---|---|---|---|")
    for B, H, W, Cin, Cout, k, s in shapes:
        key = jax.random.PRNGKey(0)
        x_bf = jax.random.normal(key, (B, H, W, Cin), jnp.bfloat16)
        w_bf = jax.random.normal(jax.random.fold_in(key, 1), (k, k, Cin, Cout), jnp.bfloat16)
        x_i8 = jax.random.randint(key, (B, H, W, Cin), -128, 128, dtype=jnp.int8)
        w_i8 = jax.random.randint(jax.random.fold_in(key, 1), (k, k, Cin, Cout), -128, 128, dtype=jnp.int8)
        cs = jnp.ones((Cout,), jnp.float32) * 0.01

        t_bf = time_fn(lambda x, w: conv_ops.conv2d(x, w, stride=s, padding=k // 2), x_bf, w_bf)
        t_i8 = time_fn(
            lambda x, w: conv_ops.scaled_int8_conv2d(x, w, cs, stride=s, padding=k // 2),
            x_i8, w_i8,
        )
        print(
            f"| {B},{H},{W},{Cin}->{Cout} {k} {s} | {t_bf*1e3:.2f} | {t_i8*1e3:.2f} "
            f"| {t_bf/t_i8:.2f}x |", flush=True,
        )


if __name__ == "__main__":
    main()
