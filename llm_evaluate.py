"""LLM evaluation driver (llm_evaluate.py analog).

The reference wraps an optionally-quantized, optionally-checkpoint-loaded
HF model in lm-eval's HFLM and runs harness tasks (llm_evaluate.py:51-56),
with quantize-BEFORE-checkpoint-load ordering so BitNet packed checkpoints
restore correctly (:46-49). This driver keeps that ordering and ships two
built-in tasks that work offline:

  - perplexity: token-level ppl over a dataset (--eval_ds JSON)
  - hellaswag: 4-choice accuracy (HF streaming or --hellaswag_data local)

plus --generate for a qualitative sample via the INT8-KV-cache decoder.

Example:
  python llm_evaluate.py --ckpt runs/.../last.pkl --quantize mixed_precision \
      --tasks perplexity --eval_ds '{"type":"token","dataset_dir":"data/ts"}'
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="llama2-470m")
    parser.add_argument("--model_kwargs", type=json.loads, default=dict())
    parser.add_argument("--seq_len", type=int, default=2048)

    parser.add_argument("--quantize")
    parser.add_argument("--quantize_kwargs", type=json.loads, default=dict())
    parser.add_argument("--quantize_lm_head", action="store_true")

    parser.add_argument("--ckpt")
    parser.add_argument("--tasks", nargs="+", default=["perplexity"])
    parser.add_argument("--eval_ds", type=json.loads)
    parser.add_argument("--max_batches", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=8)

    parser.add_argument("--hellaswag_tokenizer", default="llama3")
    parser.add_argument("--hellaswag_data")
    parser.add_argument("--task_data", help="local jsonl for arc/piqa/mc tasks")
    parser.add_argument("--max_rows", type=int)
    parser.add_argument("--generate", type=int, default=0)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--seed", type=int, default=2024)
    args = parser.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from quantized_training_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()

    import dataclasses

    import jax.numpy as jnp

    from quantized_training_tpu import quant
    from quantized_training_tpu.data import BatchLoader, get_dataset
    from quantized_training_tpu.models import llama, llama_infer
    from quantized_training_tpu.train import make_eval_step
    from quantized_training_tpu.utils import load_checkpoint

    named = {"llama2-470m": llama.LLAMA2_470M, "llama2-1b": llama.LLAMA2_1B}
    cfg = named[args.model] if args.model in named else llama.LlamaConfig.from_hf_json(args.model)
    cfg = dataclasses.replace(
        cfg,
        max_position_embeddings=args.seq_len,
        bitnet=args.quantize == "bitnet",
        **args.model_kwargs,
    )

    params = llama.init_params(jax.random.PRNGKey(args.seed), cfg)
    # quantize BEFORE loading the checkpoint (llm_evaluate.py:46-49): the
    # checkpoint's leaves are the quantized-wrapper pytrees
    qparams = quant.quantize_params(params, args.quantize, **args.quantize_kwargs)
    if args.ckpt:
        ckpt = load_checkpoint(args.ckpt)
        state = ckpt["state"]
        saved = state[0] if isinstance(state, (tuple, list)) else state["params"]
        qparams = jax.tree.map(jnp.asarray, saved)
        print(f"loaded checkpoint {args.ckpt}")

    results = {}
    for task in args.tasks:
        if task == "perplexity":
            assert args.eval_ds is not None, "--eval_ds required for perplexity"
            if args.eval_ds.get("type") == "synthetic":
                args.eval_ds.setdefault("vocab_size", cfg.vocab_size)
            ds = get_dataset(seq_len=args.seq_len, eval=True, **args.eval_ds)
            loader = BatchLoader(ds, batch_size=args.batch_size)
            eval_step = make_eval_step(cfg)
            total_loss, n = 0.0, 0
            for i, (tokens, labels) in enumerate(loader):
                if i >= args.max_batches:
                    break
                total_loss += float(eval_step(qparams, jnp.asarray(tokens), jnp.asarray(labels)))
                n += 1
            loss = total_loss / max(n, 1)
            results["perplexity"] = float(np.exp(loss))
            results["eval_loss"] = loss
        elif task == "hellaswag":
            from hellaswag import evaluate_hellaswag

            results["hellaswag_acc"] = evaluate_hellaswag(
                qparams,
                cfg,
                args.hellaswag_tokenizer,
                data_path=args.hellaswag_data,
                batch_size=args.batch_size,
            )
        elif task in ("arc", "piqa", "mc"):
            from mc_eval import evaluate_mc

            assert args.task_data, f"--task_data required for {task}"
            results[f"{task}_acc"] = evaluate_mc(
                qparams,
                cfg,
                task,
                args.task_data,
                tokenizer=args.hellaswag_tokenizer,
                batch_size=args.batch_size,
                max_rows=args.max_rows,
            )
        else:
            raise ValueError(f"unknown task {task!r}")

    if args.generate:
        prompt = jnp.zeros((1, 4), jnp.int32)
        out = llama_infer.generate(
            qparams, prompt, cfg, args.generate, temperature=0.8,
            key=jax.random.PRNGKey(args.seed),
        )
        results["sample_tokens"] = np.asarray(out[0]).tolist()

    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
