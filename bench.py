"""Headline benchmark: INT8 mixed-precision Llama pretrain tokens/s/card.

Mirrors the reference's benchmark methodology (README.md:123-137,
llm_pretrain.py:228-237 tokens/sec logging): llama2-1b at seq_len 2048 and
EFFECTIVE BATCH 16 — the reference's benchmark batch — as 4 x bs4
gradient accumulation, identically for both configs; full train step (fwd
+ bwd + AdamW), INT8 dynamic row-wise quantization on the forward and
BOTH backward matmuls vs the BF16 baseline.

Timing: N steps dispatched back-to-back (donated state), ended by
``block_until_ready`` on the last loss — how a training loop runs. Needs
a GPU; a failure is an error, not a fallback.

Prints ONE JSON line:
  value        = INT8-MP training tokens/sec on this card
  vs_baseline  = (our INT8/BF16 speedup) / 1.68   [the reference's best
                 INT8-vs-BF16 speedup on its own hardware, README.md:134]

Diagnostics go to stderr.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp


def log(*a):
    print(*a, file=sys.stderr, flush=True)


N_STEPS = 8


def build_step(cfg_name: str, bs: int, seq: int, scheme: str | None,
               accum: int = 1):
    import dataclasses

    from quantized_training_tpu import optim, quant
    from quantized_training_tpu.models import llama
    from quantized_training_tpu.train import init_train_state, make_train_step

    cfg = {"llama2-1b": llama.LLAMA2_1B, "llama2-470m": llama.LLAMA2_470M}[cfg_name]
    cfg = dataclasses.replace(cfg, max_position_embeddings=seq, remat=True)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    qparams = quant.quantize_params(params, scheme)
    optimizer = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    state = init_train_state(qparams, optimizer)
    step_fn = make_train_step(cfg, optimizer)  # jitted, donated state
    shape = (accum, bs, seq) if accum > 1 else (bs, seq)
    tokens = jax.random.randint(
        jax.random.PRNGKey(1), shape, 0, cfg.vocab_size, dtype=jnp.int32
    )
    labels = jnp.roll(tokens, -1, axis=-1)
    return state, step_fn, tokens, labels


def measure(cfg_name: str, bs: int, seq: int, scheme: str | None,
            accum: int = 1) -> float:
    """Tokens/s over N_STEPS back-to-back steps after compile + warm-up."""
    t0 = time.perf_counter()
    state, step_fn, tokens, labels = build_step(cfg_name, bs, seq, scheme, accum)
    key = jax.random.PRNGKey(2)
    for i in range(2):  # compile + warm
        state, m = step_fn(state, tokens, labels, 1e-4, jax.random.fold_in(key, i))
    log(f"  compile+warm {time.perf_counter() - t0:.0f}s, loss={float(m['loss']):.3f}")
    t0 = time.perf_counter()
    for i in range(N_STEPS):
        state, m = step_fn(
            state, tokens, labels, 1e-4, jax.random.fold_in(key, 100 + i)
        )
    jax.block_until_ready(m["loss"])
    dt = (time.perf_counter() - t0) / N_STEPS
    assert jnp.isfinite(m["loss"]), m["loss"]
    log(f"  {dt * 1e3:.1f} ms/step")
    return accum * bs * seq / dt


def main():
    from quantized_training_tpu.utils.runtime import (
        gpu_name_and_power_limit, require_gpu, setup_compile_cache,
    )

    info = require_gpu()
    setup_compile_cache()
    card = gpu_name_and_power_limit()
    cfg_name, bs, seq, accum = "llama2-1b", 4, 2048, 4
    log(f"benchmarking on {card}")
    int8_toks = measure(cfg_name, bs, seq, "mixed_precision", accum)
    bf16_toks = measure(cfg_name, bs, seq, None, accum)
    speedup = int8_toks / bf16_toks
    log(
        f"RESULT {cfg_name} bs={bs}x{accum} (eff {bs * accum}): "
        f"bf16={bf16_toks:,.0f} tok/s  "
        f"int8_mp={int8_toks:,.0f} tok/s  speedup={speedup:.3f}x "
        f"(reference best: 1.68x at bs16)"
    )
    print(
        json.dumps(
            {
                "metric": f"{cfg_name}_int8_mixed_precision_train_tokens_per_sec_per_card",
                "value": round(int8_toks, 1),
                "unit": "tok/s",
                "vs_baseline": round(speedup / 1.68, 4),
                "detail": {
                    "bf16_tokens_per_sec": round(bf16_toks, 1),
                    "int8_vs_bf16_speedup": round(speedup, 4),
                    "batch_size": bs,
                    "grad_accum": accum,
                    "effective_batch": bs * accum,
                    "seq_len": seq,
                    "card": card,
                    "device": info,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
