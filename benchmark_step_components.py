"""Component timings of the llama2-1b train step on the GPU, at the step's
own shapes (4 x 2048 tokens, D 2048, F 5632, 32 heads, KV 4).

Each component is what XLA compiles from the plain jnp code that stays in
the repository, with its share of the card's data-sheet roofline:

- attention fwd+bwd per layer: cuDNN fused flash attention against XLA's
  einsum composite (``llama.attention`` impl 'cudnn' / 'xla');
- the int8 GEMM forms (fwd, dgrad, wgrad) and the bf16 GEMM of the same
  shape; the XLA tile-scaled path;
- quantize passes (rowwise, colwise, both-axis) and the producer fusions
  around them (rms_norm -> quantize, silu*mul -> quantize);
- rope on q;
- the AdamW update over all llama2-1b parameters (fp32 states, and bf16
  states with stochastic rounding);
- a large bf16 GEMM and a large copy, for what the card reaches.

Times are wall time per call over back-to-back calls ended by
``block_until_ready``. Usage: python benchmark_step_components.py
[--out runs/components.json]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import jax
import jax.numpy as jnp

B, S, H, KV, HD, D, F = 4, 2048, 32, 4, 64, 2048, 5632
T = B * S


def time_ms(fn, *args, n=20):
    """Mean ms per call of a jitted fn (compile and first call excluded)."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/components.json")
    args = ap.parse_args()

    from quantized_training_tpu import optim
    from quantized_training_tpu.models import llama
    from quantized_training_tpu.ops import fp8, scaled_mm_general
    from quantized_training_tpu.ops.scaled_mm import scaled_mm
    from quantized_training_tpu.quant.core import quantize_int8, quantize_int8_both
    from quantized_training_tpu.utils.runtime import (
        gpu_name_and_power_limit, peaks, require_gpu, setup_compile_cache,
    )

    info = require_gpu()
    setup_compile_cache()
    pk = peaks()
    card = gpu_name_and_power_limit()
    print(card, info)
    rows = []

    def record(name, ms, flops=0.0, nbytes=0.0, peak_flops=None):
        floor_ms = max(
            flops / (peak_flops * 1e12) if flops else 0.0,
            nbytes / (pk["hbm_tbps"] * 1e12),
        ) * 1e3
        row = dict(name=name, ms=ms, tflops=flops / ms / 1e9 if flops else None,
                   gbps=nbytes / ms / 1e6 if nbytes else None,
                   roofline_share=floor_ms / ms if floor_ms else None)
        rows.append(row)
        print(json.dumps(row), flush=True)

    keys = iter(jax.random.split(jax.random.PRNGKey(0), 32))
    bf = lambda shape, scale=1.0: (jax.random.normal(next(keys), shape) * scale).astype(jnp.bfloat16)

    # attention fwd+bwd, one layer
    q, k, v = bf((B, S, H, HD)), bf((B, S, KV, HD)), bf((B, S, KV, HD))
    dout = bf((B, S, H, HD))
    attn_flops = 4 * B * H * S * S * HD / 2  # causal: half the square
    for impl in ("cudnn", "xla"):
        fwd = jax.jit(lambda q, k, v, impl=impl: llama.attention(q, k, v, impl))
        fb = jax.jit(jax.grad(
            lambda q, k, v, impl=impl: jnp.sum(
                llama.attention(q, k, v, impl).astype(jnp.float32) * dout),
            argnums=(0, 1, 2)))
        record(f"attention fwd {impl}", time_ms(fwd, q, k, v), attn_flops,
               peak_flops=pk["bf16_tflops"])
        record(f"attention fwd+bwd {impl}", time_ms(fb, q, k, v), 3.5 * attn_flops,
               peak_flops=pk["bf16_tflops"])

    # GEMMs at the MLP's [T, D] x [D, F] shape
    gemm_flops = 2 * T * D * F
    for dims, name in (((1, 1), "fwd"), ((1, 0), "dgrad"), ((0, 0), "wgrad")):
        a = bf((T, D) if dims[0] == 1 else (D, T))
        b = bf((F, D) if dims[1] == 1 else (D, F))
        a_q, sa = quantize_int8(a, axis=dims[0])
        b_q, sb = quantize_int8(b, axis=dims[1])
        f = jax.jit(lambda a, b, sa, sb, dims=dims: scaled_mm_general(a, b, sa, sb, dims=dims))
        record(f"int8 gemm {name}", time_ms(f, a_q, b_q, sa, sb), gemm_flops,
               peak_flops=pk["int8_tops"])
    a, b = bf((T, D)), bf((D, F))
    record("bf16 gemm", time_ms(jax.jit(jnp.matmul), a, b), gemm_flops,
           peak_flops=pk["bf16_tflops"])
    a_q, sa = fp8.quantize_fp8(a, axis=1)
    b_q, sb = fp8.quantize_fp8(b, axis=0)
    record("fp8 row gemm (bf16 upcast)", time_ms(jax.jit(scaled_mm), a_q, b_q, sa, sb),
           gemm_flops, peak_flops=pk["bf16_tflops"])
    a_q, sa = fp8.quantize_fp8_tile(a)
    b_q, sb = fp8.quantize_fp8_block(b)
    record("fp8 tile gemm (XLA partials)", time_ms(jax.jit(scaled_mm), a_q, b_q, sa, sb),
           gemm_flops, peak_flops=pk["bf16_tflops"])
    big = bf((8192, 8192))
    record("bf16 gemm 8192^3", time_ms(jax.jit(jnp.matmul), big, big), 2 * 8192**3,
           peak_flops=pk["bf16_tflops"])
    record("copy 1 GiB", time_ms(jax.jit(lambda x: x * 2), bf((2**29,))), 0.0, 2 * 2**30)

    # quantize passes and the producer fusions around them
    g = bf((T, F))
    for axis in (1, 0):
        f = jax.jit(lambda x, axis=axis: quantize_int8(x, axis=axis))
        record(f"quantize axis={axis} [{T},{F}]", time_ms(f, g), 0.0, T * F * 3)
    record(f"quantize both [{T},{F}]", time_ms(jax.jit(quantize_int8_both), g), 0.0, T * F * 4)
    x, gamma = bf((T, D)), jnp.ones((D,), jnp.bfloat16)
    f = jax.jit(lambda x, g: quantize_int8(llama.rms_norm(x, g, 1e-5), axis=1))
    record(f"rms_norm -> quantize [{T},{D}]", time_ms(f, x, gamma), 0.0, T * D * 3)
    gate, up = bf((T, F)), bf((T, F))
    f = jax.jit(lambda a, b: quantize_int8(jax.nn.silu(a) * b, axis=1))
    record(f"silu*mul -> quantize [{T},{F}]", time_ms(f, gate, up), 0.0, T * F * 5)
    cos, sin = llama.rope_tables(llama.LLAMA2_1B, S)
    record("rope q", time_ms(jax.jit(llama.apply_rope), q, cos, sin), 0.0, q.size * 4)

    # optimizer update over the llama2-1b parameter tree
    params = llama.init_params(jax.random.PRNGKey(1), llama.LLAMA2_1B)
    n_params = llama.num_params(params)
    grads = jax.tree.map(lambda p: p * 0.01, params)
    for name, opt, bytes_per in (("adamw fp32 states", optim.adamw(), 2 + 2 + 16 + 2),
                                 ("adamw bf16 states + SR", optim.adamw_bf16_sr(), 2 + 2 + 8 + 2)):
        state = opt.init(params)
        f = jax.jit(lambda g, s, p, opt=opt: opt.step(g, s, p, 1e-4, jax.random.PRNGKey(0)))
        record(f"{name} ({n_params} params)", time_ms(f, grads, state, params, n=5),
               0.0, n_params * bytes_per)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(card=card, device=info, peaks=pk, rows=rows), fh, indent=1)


if __name__ == "__main__":
    main()
