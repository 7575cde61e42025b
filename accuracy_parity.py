"""Task-accuracy parity: BF16 vs quantized training on an identical task.

Offline stand-in for the north star's "hellaswag accuracy within the
reference's INT8 delta" clause (BASELINE.md: derived targets): hellaswag
itself needs network egress, so this trains matched models — same init
seed, same Markov-chain data stream, same step count — under each
quantization scheme and scores every checkpoint on the SAME generated
multiple-choice eval set (mc_eval.generate_markov_mc, the min-summed-
continuation-CE recipe hellaswag.py uses).

The model is sized so the default quantization filter actually engages
(every attention/MLP linear dim >= 128 — quant/api.py skips small
linears), i.e. the quantized configs really train through scaled-INT8/FP8
matmuls, not silently in bf16.

Usage:
    python accuracy_parity.py --steps 1200 --out runs/parity.json

Prints one markdown table row per config plus a JSON summary; the README
"Task-accuracy parity" table is produced by this script.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


CONFIGS = [
    # (name, scheme, scheme_kwargs)
    ("bf16", None, {}),
    ("int8 mixed-precision", "mixed_precision", {}),
    ("int8 mixed-precision + SR", "mixed_precision", {"stochastic_rounding": True}),
    ("fp8_e4m3 row-scaled", "mixed_precision", {"dtype": "fp8_e4m3"}),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--seq_len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--eval_rows", type=int, default=400)
    ap.add_argument("--out", default="runs/parity.json")
    ap.add_argument("--configs", type=json.loads, help="subset of config names")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp

    from quantized_training_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()
    from mc_eval import evaluate_mc, generate_markov_mc
    from quantized_training_tpu import optim, quant
    from quantized_training_tpu.data import BatchLoader
    from quantized_training_tpu.data.text import MarkovTokenDataset
    from quantized_training_tpu.models import llama
    from quantized_training_tpu.train import init_train_state, make_train_step

    # Dims >= 128 everywhere so the default quantization filter engages.
    cfg = llama.LlamaConfig(
        vocab_size=2048,
        hidden_size=256,
        intermediate_size=1024,
        num_hidden_layers=4,
        num_attention_heads=4,
        num_key_value_heads=4,
        max_position_embeddings=args.seq_len,
    )
    chain = dict(vocab_size=cfg.vocab_size, n_states=512, branching=4)

    eval_path = "runs/parity_mc.jsonl"
    generate_markov_mc(
        eval_path, n_rows=args.eval_rows, prompt_len=24, cont_len=6,
        n_choices=4, **chain,
    )
    log(f"eval set: {args.eval_rows} rows at {eval_path}")

    results = []
    for name, scheme, kwargs in CONFIGS:
        if args.configs and name not in args.configs:
            continue
        t0 = time.time()
        params = llama.init_params(jax.random.PRNGKey(0), cfg)
        qparams = quant.quantize_params(params, scheme, **kwargs)
        if scheme is not None:
            is_wrapped = lambda x: hasattr(x, "config")
            n_wrapped = sum(
                1 for l in jax.tree.leaves(qparams, is_leaf=is_wrapped)
                if is_wrapped(l)
            )
            assert n_wrapped > 0, "quantization filter skipped everything"
        opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
        state = init_train_state(qparams, opt)
        step = make_train_step(cfg, opt)

        ds = MarkovTokenDataset(seq_len=args.seq_len, **chain)
        loader = iter(BatchLoader(ds, batch_size=args.batch_size))
        loss = float("nan")
        for i in range(args.steps):
            tok, lab = next(loader)
            state, metrics = step(
                state, jnp.asarray(tok), jnp.asarray(lab), args.lr,
                jax.random.PRNGKey(i),
            )
            if (i + 1) % 200 == 0 or i == args.steps - 1:
                loss = float(metrics["loss"])  # always sampled at the end
                log(f"  {name}: step {i + 1} loss {loss:.4f}")

        trained = quant.merge_masters(
            quant.virtual_params(state.params), state.params
        )
        acc = evaluate_mc(
            trained, cfg, "mc", eval_path, tokenizer="ints", batch_size=16
        )
        results.append(
            dict(config=name, accuracy=acc, final_loss=loss,
                 train_s=round(time.time() - t0, 1))
        )
        log(f"{name}: accuracy {acc:.4f} (loss {loss:.4f}, "
            f"{results[-1]['train_s']}s)")

    print("\n| Training config | MC accuracy | final loss |")
    print("|---|---|---|")
    for r in results:
        print(f"| {r['config']} | {r['accuracy']:.3f} | {r['final_loss']:.3f} |")
    with open(args.out, "w") as f:
        json.dump(
            dict(steps=args.steps, batch_size=args.batch_size,
                 seq_len=args.seq_len, eval_rows=args.eval_rows,
                 results=results),
            f, indent=2,
        )
    log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
