"""LLM instruction finetuning driver (llm_finetune.py analog).

Parity points with the reference:
  - variable-length samples padded per-batch to the next multiple of
    --seq_len_multiple (llm_finetune.py:21-39) so a handful of shapes are
    compiled instead of one per length; labels use -100 padding
  - the MetaMathQA instruction template (llm_finetune.py:47-53)
  - lm_head is never quantized (it may be weight-tied,
    llm_finetune.py:109-110)
  - model-only checkpoints (llm_finetune.py:153-159)

Data sources: 'metamathqa' (HF, needs egress), or a local JSONL with
{"query": ..., "response": ...} rows, or 'synthetic'.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from datetime import datetime
from pathlib import Path

import numpy as np

TEMPLATE = (
    "Below is an instruction that describes a task. "
    "Write a response that appropriately completes the request.\n\n"
    "### Instruction:\n{query}\n\n"
    "### Response: Let's think step by step. {response}"
)


def data_iter(tokens_list, batch_size: int, seq_len_multiple: int, seed: int):
    """Shuffle + pad each batch to a multiple of seq_len_multiple
    (llm_finetune.py:21-39). Yields (inputs, labels) int32/-100-padded."""
    rng = np.random.default_rng(seed)
    n = len(tokens_list)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            batch = [tokens_list[j] for j in order[i : i + batch_size]]
            length = max(
                math.ceil(len(x) / seq_len_multiple) * seq_len_multiple for x in batch
            )
            inputs = np.zeros((batch_size, length), np.int32)
            labels = np.full((batch_size, length), -100, np.int64)
            for bi, toks in enumerate(batch):
                inputs[bi, : len(toks)] = toks
                labels[bi, : len(toks)] = toks
            yield inputs, labels


def load_samples(args, tokenizer):
    if args.dataset == "metamathqa":
        from datasets import load_dataset

        ds = load_dataset("meta-math/MetaMathQA", split="train")
        rows = ({"query": r["query"], "response": r["response"]} for r in ds)
    elif args.dataset == "synthetic":
        rng = np.random.default_rng(0)
        return [
            rng.integers(0, args_vocab(args), rng.integers(16, args.max_seq_len))
            .astype(np.int32)
            .tolist()
            for _ in range(256)
        ]
    else:  # local jsonl
        rows = (json.loads(line) for line in open(args.dataset))

    out = []
    for r in rows:
        toks = tokenizer(TEMPLATE.format(**r), add_bos=True, add_eos=True)
        out.append(toks[: args.max_seq_len])
    return out


def args_vocab(args) -> int:
    return args.model_kwargs.get("vocab_size", 32000)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="llama2-470m")
    parser.add_argument("--model_kwargs", type=json.loads, default=dict())
    parser.add_argument("--init_ckpt", help="pretrained checkpoint to start from")

    parser.add_argument("--quantize")
    parser.add_argument("--quantize_kwargs", type=json.loads, default=dict())

    parser.add_argument("--dataset", default="synthetic",
                        help="metamathqa | synthetic | path/to/data.jsonl")
    parser.add_argument("--tokenizer", default="llama3")
    parser.add_argument("--max_seq_len", type=int, default=2048)
    parser.add_argument("--seq_len_multiple", type=int, default=256)

    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--n_steps", type=int, default=1000)

    parser.add_argument("--optim", default="adamw")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--optim_kwargs", type=json.loads, default=dict())

    parser.add_argument("--ckpt_interval", type=int, default=1000)
    parser.add_argument("--run_name", default="run")
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--log_interval", type=int, default=50)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from quantized_training_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()

    import dataclasses

    import jax.numpy as jnp

    from quantized_training_tpu import optim, quant
    from quantized_training_tpu.data import get_tokenizer
    from quantized_training_tpu.models import llama
    from quantized_training_tpu.train import init_train_state, make_train_step
    from quantized_training_tpu.utils import load_checkpoint, print_model_stats, save_checkpoint
    from quantized_training_tpu.utils.logging import MetricLogger

    named = {"llama2-470m": llama.LLAMA2_470M, "llama2-1b": llama.LLAMA2_1B}
    cfg = named[args.model] if args.model in named else llama.LlamaConfig.from_hf_json(args.model)
    cfg = dataclasses.replace(
        cfg,
        max_position_embeddings=args.max_seq_len,
        remat=True,
        bitnet=args.quantize == "bitnet",
        **args.model_kwargs,
    )
    key = jax.random.PRNGKey(args.seed)
    params = llama.init_params(jax.random.fold_in(key, 0), cfg)

    # never quantize lm_head here: it may be weight-tied (llm_finetune.py:109)
    def not_lm_head(path, leaf):
        from quantized_training_tpu.quant.api import _is_linear_weight_path

        names = [getattr(p, "key", None) for p in path]
        return _is_linear_weight_path(path) and "lm_head" not in names

    qparams = quant.quantize_params(
        params, args.quantize, filter_fn=not_lm_head, **args.quantize_kwargs
    )
    if args.init_ckpt:
        ckpt = load_checkpoint(args.init_ckpt)
        qparams = jax.tree.map(jnp.asarray, ckpt["state"][0]
                               if isinstance(ckpt["state"], (tuple, list))
                               else ckpt["state"]["params"])
    print_model_stats(params)

    optimizer = optim.get_optimizer(args.optim, weight_decay=args.weight_decay, **args.optim_kwargs)
    state = init_train_state(qparams, optimizer)
    step_fn = make_train_step(cfg, optimizer)

    tokenizer = get_tokenizer(args.tokenizer) if args.dataset != "synthetic" else None
    samples = load_samples(args, tokenizer)
    print(f"Training dataset size: {len(samples):,}")
    it = data_iter(samples, args.batch_size, args.seq_len_multiple, args.seed)

    save_dir = Path("runs/llm_finetune") / (
        f"{datetime.now().strftime('%Y%m%d_%H%M%S')}_{args.run_name}"
    )
    logger = MetricLogger(save_dir)

    step = 0
    time0 = time.time()
    while step < args.n_steps:
        inputs, labels = next(it)
        state, metrics = step_fn(
            state,
            jnp.asarray(inputs),
            jnp.asarray(labels),
            args.lr,
            jax.random.fold_in(key, 1_000_000 + step),
        )
        step += 1
        if step % args.log_interval == 0 or step == args.n_steps:
            jax.block_until_ready(metrics["loss"])
            time1 = time.time()
            log = dict(
                loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]),
                lr=args.lr,
                seq_len=int(inputs.shape[1]),
                steps_per_second=min(args.log_interval, step) / (time1 - time0),
            )
            time0 = time1
            logger.log(log, step)
            print(f"step {step}: " + " ".join(f"{k}={v:.4g}" for k, v in log.items()))

        if args.ckpt_interval > 0 and step % args.ckpt_interval == 0:
            # model-only checkpoint (llm_finetune.py:153-159)
            save_checkpoint(save_dir / "last.pkl",
                            {"state": {"params": state.params}, "meta": {"step": step}})

    logger.finish()
    print(f"done; artifacts in {save_dir}")


if __name__ == "__main__":
    main()
