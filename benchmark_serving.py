"""Continuous-batching serving throughput: windowed vs full-cache decode.

The Server dispatches each decode step to a kernel compiled for the
smallest power-of-two attention window covering the deepest active slot
(models/serving.py). This benchmark drains an identical request mix
through (a) the windowed server and (b) a server pinned to the single
full-``max_len`` window, and reports generated tokens/sec for both.

The reference has no serving layer (BASELINE.json north-star item); the
comparison here is our own full-window decode, i.e. the cost of attending
over ``max_len`` regardless of fill.

Usage: python benchmark_serving.py [--model llama2-1b] [--n_slots 8]
       [--max_len 2048] [--prompt_len 64] [--new_tokens 448]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import jax
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def drain(srv, prompts, new_tokens):
    for p in prompts:
        srv.add_request(p, max_new_tokens=new_tokens)
    n = 0
    while srv.pending():
        n += len(srv.step())
    return n


def measure(params, cfg, args, window_buckets):
    from quantized_training_tpu.models.serving import Server

    srv = Server(params, cfg, n_slots=args.n_slots, max_len=args.max_len,
                 window_buckets=window_buckets,
                 decode_chunk=args.decode_chunk)
    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(1, cfg.vocab_size, size=args.prompt_len).tolist()
        for _ in range(args.n_slots)
    ]
    # warmup = identical drain on the SAME server (jitted fns live on the
    # instance), so the prefill bucket AND every window the timed run
    # reaches are compiled before timing; the drain leaves all slots free
    drain(srv, prompts, args.new_tokens)
    t0 = time.perf_counter()
    n = drain(srv, prompts, args.new_tokens)
    dt = time.perf_counter() - t0
    return n / dt, sorted(getattr(srv, "_decode_fns", {}))


MIX_PROMPTS = (32, 96, 224, 480)
MIX_BUDGETS = (64, 160, 320, 448)


def _mixed_requests(n_req, vocab):
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n_req):
        n = MIX_PROMPTS[i % len(MIX_PROMPTS)]
        reqs.append(
            (rng.integers(1, vocab, size=n).tolist(),
             MIX_BUDGETS[i % len(MIX_BUDGETS)])
        )
    return reqs


def drain_mixed(srv, reqs):
    for prompt, budget in reqs:
        srv.add_request(prompt, max_new_tokens=budget)
    n = 0
    while srv.pending():
        n += len(srv.step())
    return n


def measure_mixed(params, cfg, args, window_buckets):
    """Queue-pressure load: 3x n_slots requests with mixed prompt lengths
    and budgets; short requests finish early, freeing slots for queued
    ones mid-flight (continuous batching + window switching under churn).
    """
    from quantized_training_tpu.models.serving import Server

    srv = Server(params, cfg, n_slots=args.n_slots, max_len=args.max_len,
                 window_buckets=window_buckets,
                 decode_chunk=args.decode_chunk)
    reqs = _mixed_requests(3 * args.n_slots, cfg.vocab_size)
    drain_mixed(srv, reqs)  # warmup: compiles every bucket/window reached
    t0 = time.perf_counter()
    n = drain_mixed(srv, reqs)
    dt = time.perf_counter() - t0
    return n / dt, sorted(getattr(srv, "_decode_fns", {}))


def measure_static_generate(params, cfg, args):
    """The no-server baseline for the SAME mixed request set: static
    batched generate() must pad every prompt to the longest and run every
    sequence to the largest budget, in ceil(n_req / n_slots) sequential
    batches; useful-token throughput = requested tokens / wall time."""
    import jax.numpy as jnp

    from quantized_training_tpu.models.llama_infer import generate

    reqs = _mixed_requests(3 * args.n_slots, cfg.vocab_size)
    useful = sum(b for _, b in reqs)
    pmax = max(len(p) for p, _ in reqs)
    bmax = max(b for _, b in reqs)
    batches = []
    for i in range(0, len(reqs), args.n_slots):
        chunk = reqs[i:i + args.n_slots]
        arr = np.zeros((len(chunk), pmax), np.int32)
        for j, (p, _) in enumerate(chunk):
            arr[j, -len(p):] = p  # left-pad: last position is real
        batches.append(jnp.asarray(arr))

    def run():
        for b in batches:
            out = generate(params, b, cfg, bmax, max_len=args.max_len)
            np.asarray(jax.device_get(out[:, -1]))

    run()  # warmup/compile
    t0 = time.perf_counter()
    run()
    return useful / (time.perf_counter() - t0)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="llama2-1b")
    p.add_argument("--n_slots", type=int, default=8)
    p.add_argument("--max_len", type=int, default=2048)
    p.add_argument("--prompt_len", type=int, default=64)
    p.add_argument("--new_tokens", type=int, default=448)
    p.add_argument("--quantize", default=None)
    p.add_argument("--decode_chunk", type=int, default=16,
                   help="device-side decode chunk (tokens per dispatch)")
    p.add_argument("--load", choices=("uniform", "mixed"), default="uniform",
                   help="mixed: 3x n_slots requests, mixed prompt lengths/"
                   "budgets, plus a static batched generate() baseline")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    from quantized_training_tpu.utils.runtime import require_gpu, setup_compile_cache

    if args.cpu:  # harness check only: no number of a CPU run is a device metric
        jax.config.update("jax_platforms", "cpu")
    else:
        require_gpu()
    setup_compile_cache()

    from quantized_training_tpu import quant
    from quantized_training_tpu.models import llama

    tiny = llama.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=args.max_len,
    )  # CPU smoke-test config
    cfg = {"llama2-1b": llama.LLAMA2_1B, "llama2-470m": llama.LLAMA2_470M,
           "tiny": tiny}[args.model]
    cfg = dataclasses.replace(cfg, max_position_embeddings=args.max_len)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    params = quant.quantize_params(params, args.quantize)

    if args.load == "mixed":
        tok_w, wins = measure_mixed(params, cfg, args, None)
        log(f"windowed server (mixed load): {tok_w:.1f} tok/s "
            f"(windows compiled: {wins})")
        tok_f, _ = measure_mixed(params, cfg, args, (args.max_len,))
        log(f"full-window server (mixed load): {tok_f:.1f} tok/s")
        tok_s = measure_static_generate(params, cfg, args)
        log(f"static batched generate (padded): {tok_s:.1f} useful tok/s")
        log(f"windowed/full = {tok_w / tok_f:.3f}x, "
            f"windowed/static = {tok_w / tok_s:.3f}x")
        return
    tok_w, wins = measure(params, cfg, args, None)
    log(f"windowed decode: {tok_w:.1f} tok/s (windows compiled: {wins})")
    tok_f, _ = measure(params, cfg, args, (args.max_len,))
    log(f"full-window decode: {tok_f:.1f} tok/s")
    log(f"windowed / full = {tok_w / tok_f:.3f}x")


if __name__ == "__main__":
    main()
