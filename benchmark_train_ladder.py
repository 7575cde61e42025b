"""INT8 mixed-precision training-speed ladder (the reference README table).

Reproduces the reference's headline benchmark (README.md:123-137,
BASELINE.md): Llama2-1B, seq 2048, full train step, stepping through
which matmuls run INT8 — forward only, + grad_input, + grad_weight —
with and without stochastic rounding, against the BF16 baseline.

Prints one table row per rung: tok/s and speedup vs BF16.

Usage: python benchmark_train_ladder.py [--bs 8] [--seq 2048] [--sr]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import jax
import jax.numpy as jnp


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def measure(cfg, params_host, scheme_kwargs, bs, seq, n_steps=6, accum=1):
    from quantized_training_tpu import optim, quant
    from quantized_training_tpu.train import init_train_state, make_train_step

    scheme = None if scheme_kwargs is None else "mixed_precision"
    qparams = quant.quantize_params(
        jax.tree.map(jnp.asarray, params_host), scheme, **(scheme_kwargs or {})
    )
    optimizer = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    state = init_train_state(qparams, optimizer)
    step_fn = make_train_step(cfg, optimizer)
    # accum > 1: [accum, bs, seq] micro-batches through the lax.scan
    # accumulation path (e.g. 2 x bs8 for the reference's bs16 rows,
    # README.md:125)
    shape = (accum, bs, seq) if accum > 1 else (bs, seq)
    tokens = jax.random.randint(
        jax.random.PRNGKey(1), shape, 0, cfg.vocab_size, jnp.int32
    )
    labels = jnp.roll(tokens, -1, axis=-1)
    key = jax.random.PRNGKey(2)

    state, m = step_fn(state, tokens, labels, 1e-4, key)
    jax.block_until_ready(m["loss"])
    # back-to-back steps ended by one block (same methodology as bench.py)
    t0 = time.perf_counter()
    for i in range(n_steps):
        state, m = step_fn(
            state, tokens, labels, 1e-4, jax.random.fold_in(key, 100 + i)
        )
    jax.block_until_ready(m["loss"])
    dt = (time.perf_counter() - t0) / n_steps
    del state, qparams
    return accum * bs * seq / dt


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="llama2-1b")
    parser.add_argument("--bs", type=int, default=8)
    parser.add_argument("--seq", type=int, default=2048)
    parser.add_argument("--sr", action="store_true",
                        help="also measure stochastic-rounding variants")
    parser.add_argument("--accum", type=int, default=1,
                        help="gradient-accumulation micro-steps (effective "
                        "batch = accum x bs; 2 x bs8 ~ the reference's bs16)")
    parser.add_argument("--rungs", default=None,
                        help="comma-separated substring filter over rung names "
                        "(e.g. 'BF16,grad_weight') — each unmatched rung is "
                        "skipped")
    args = parser.parse_args()

    from quantized_training_tpu.utils.runtime import (
        gpu_name_and_power_limit, require_gpu, setup_compile_cache,
    )

    require_gpu()
    setup_compile_cache()

    from quantized_training_tpu.models import llama

    cfg = {"llama2-1b": llama.LLAMA2_1B, "llama2-470m": llama.LLAMA2_470M}[args.model]
    cfg = dataclasses.replace(cfg, max_position_embeddings=args.seq, remat=True)
    params_host = jax.device_get(llama.init_params(jax.random.PRNGKey(0), cfg))

    rungs = [
        ("BF16 baseline", None),
        ("INT8 forward", dict(output=True, grad_input=False, grad_weight=False)),
        ("+ INT8 grad_input", dict(output=True, grad_input=True, grad_weight=False)),
        ("+ INT8 grad_weight", dict(output=True, grad_input=True, grad_weight=True)),
    ]
    if args.sr:
        rungs += [
            ("INT8 fwd + SR", dict(output=True, grad_input=False,
                                   grad_weight=False, stochastic_rounding=True)),
            ("all INT8 + SR", dict(output=True, grad_input=True,
                                   grad_weight=True, stochastic_rounding=True)),
        ]

    log(f"device: {gpu_name_and_power_limit()}, {args.model} "
        f"bs={args.bs} seq={args.seq} accum={args.accum} "
        f"(reference table: README.md:123-137 on 4070Ti)")
    if args.rungs:
        pats = [p.strip() for p in args.rungs.split(",") if p.strip()]
        rungs = [(n, kw) for n, kw in rungs if any(p in n for p in pats)]

    results = []
    base = None
    for name, kw in rungs:
        toks = measure(cfg, params_host, kw, args.bs, args.seq, accum=args.accum)
        if base is None:
            base = toks
        results.append((name, toks, toks / base))
        log(f"{name}: {toks:,.0f} tok/s ({toks/base:.2f}x)")

    print(f"\n| Configuration | tok/s | speedup | reference ({'4070Ti'}) |")
    print("|---|---|---|---|")
    ref = {"BF16 baseline": "9,223 (1.00x)", "INT8 forward": "11,751 (1.27x)",
           "+ INT8 grad_input": "13,678 (1.48x)", "+ INT8 grad_weight": "15,517 (1.68x)",
           "INT8 fwd + SR": "10,944 (1.19x)", "all INT8 + SR": "OOM"}
    for name, toks, sp in results:
        print(f"| {name} | {toks:,.0f} | {sp:.2f}x | {ref.get(name, '-')} |")


if __name__ == "__main__":
    main()
