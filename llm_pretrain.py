"""LLM pretraining driver (the llm_pretrain.py analog).

CLI parity with the reference (llm_pretrain.py:40-74): --quantize +
--quantize_kwargs JSON, --train_ds JSON, gradient accumulation, LR schedule
kwargs, grad clipping, checkpoint/resume including dataloader state,
periodic metrics (loss, grad_norm, lr, tokens/sec, memory), optional
profiler trace, in-loop hellaswag eval hook.

Differences: one jitted train step (donated state), compiled ahead of the
loop, instead of torch.compile + in-place optimizer; DP/FSDP via a device
mesh (--mesh '{"data": N}' or '{"fsdp": N}') instead of torchrun DDP/FSDP2;
JSONL metrics instead of wandb (no network needed). ``main(argv)`` can be
called in-process and returns the run's summary.

Examples:
  python llm_pretrain.py --train_ds '{"type":"synthetic"}' --n_steps 20 \
      --batch_size 4 --seq_len 256 --quantize mixed_precision
  python llm_pretrain.py --model llama2-1b --quantize mixed_precision \
      --quantize_kwargs '{"stochastic_rounding": true}' \
      --train_ds '{"type":"token","dataset_dir":"data/tinystories"}'
"""

from __future__ import annotations

import argparse
import json
import time
from datetime import datetime
from pathlib import Path

import numpy as np


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="llama2-470m",
                        help="llama2-470m | llama2-1b | path to an HF-format config.json dir")
    parser.add_argument("--model_kwargs", type=json.loads, default=dict())

    parser.add_argument("--quantize")
    parser.add_argument("--quantize_kwargs", type=json.loads, default=dict())
    parser.add_argument("--quantize_lm_head", action="store_true")
    parser.add_argument("--activation_checkpointing", action="store_true")

    parser.add_argument("--train_ds", type=json.loads, required=True)
    parser.add_argument("--n_steps", type=int, default=1000)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--seq_len", type=int, default=2048)
    parser.add_argument("--gradient_accumulation", type=int, default=1)

    parser.add_argument("--optim", default="adamw")
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--weight_decay", type=float, default=1e-2)
    parser.add_argument("--optim_kwargs", type=json.loads, default=dict())
    parser.add_argument("--lr_schedule_kwargs", type=json.loads)
    parser.add_argument("--clip_grad_norm", type=float)

    parser.add_argument("--mesh", type=json.loads,
                        help='e.g. {"data": 4} or {"fsdp": 8} or {"data": 2, "fsdp": 4}')

    parser.add_argument("--hellaswag", action="store_true")
    parser.add_argument("--hellaswag_tokenizer", default="llama3")
    parser.add_argument("--hellaswag_interval", type=int, default=1000)

    parser.add_argument("--resume")
    parser.add_argument("--ckpt_interval", type=int, default=1000)
    parser.add_argument("--run_name", default="run")
    parser.add_argument("--save_dir", default="runs/llm_pretrain",
                        help="base directory for run artifacts")
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--log_interval", type=int, default=50)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="force CPU backend")
    parser.add_argument("--native_loader", action="store_true",
                        help="use the C++ prefetching token loader (make native)")
    args = parser.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from quantized_training_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()

    from quantized_training_tpu import optim, quant
    from quantized_training_tpu.data import BatchLoader, ShuffleDataset, get_dataset
    from quantized_training_tpu.models import llama
    from quantized_training_tpu.parallel import make_mesh, shard_batch, shard_state
    from quantized_training_tpu.train import init_train_state, make_train_step
    from quantized_training_tpu.utils import (
        LRSchedule,
        load_checkpoint,
        print_model_stats,
        save_checkpoint,
    )
    from quantized_training_tpu.utils.logging import MetricLogger

    if args.profile:
        args.n_steps = min(args.n_steps, 5)

    # ----- model -----
    named = {"llama2-470m": llama.LLAMA2_470M, "llama2-1b": llama.LLAMA2_1B}
    if args.model in named:
        cfg = named[args.model]
    else:
        cfg = llama.LlamaConfig.from_hf_json(args.model)
    overrides = dict(
        max_position_embeddings=args.seq_len,
        remat=args.activation_checkpointing,
        bitnet=args.quantize == "bitnet",
        **args.model_kwargs,
    )
    import dataclasses

    cfg = dataclasses.replace(cfg, **overrides)

    key = jax.random.PRNGKey(args.seed)
    params = llama.init_params(jax.random.fold_in(key, 0), cfg)

    # ----- quantize (llm_pretrain.py:122-124 contract) -----
    def not_lm_head(path, leaf):
        from quantized_training_tpu.quant.api import _is_linear_weight_path

        if not _is_linear_weight_path(path):
            return False
        names = [getattr(p, "key", None) for p in path]
        return args.quantize_lm_head or "lm_head" not in names

    qparams = quant.quantize_params(
        params, args.quantize, filter_fn=not_lm_head, **args.quantize_kwargs
    )
    print_model_stats(params)

    # ----- optimizer -----
    optimizer = optim.get_optimizer(
        args.optim, weight_decay=args.weight_decay, **args.optim_kwargs
    )
    lr_schedule = (
        LRSchedule(args.lr, args.n_steps, **args.lr_schedule_kwargs)
        if args.lr_schedule_kwargs is not None
        else None
    )

    # ----- data -----
    micro_bs = args.batch_size // args.gradient_accumulation
    assert micro_bs * args.gradient_accumulation == args.batch_size
    if args.train_ds.get("type") == "synthetic":
        args.train_ds.setdefault("vocab_size", cfg.vocab_size)
    if args.native_loader:
        from quantized_training_tpu.data.native_loader import NativeTokenLoader, available

        assert available(), "libtokenloader.so not built; run `make native`"
        assert args.train_ds.get("type") == "token", "--native_loader needs a token dataset"
        dloader = NativeTokenLoader(
            args.train_ds["dataset_dir"], args.seq_len, micro_bs, seed=args.seed
        )
    else:
        ds = get_dataset(seq_len=args.seq_len, eval=False, seed=args.seed, **args.train_ds)
        ds = ShuffleDataset(ds, buffer_size=max(micro_bs * 4, 1000), seed=args.seed)
        dloader = BatchLoader(ds, batch_size=micro_bs)

    # ----- state + sharding -----
    mesh = make_mesh(args.mesh) if args.mesh else None
    if mesh is not None and args.quantize == "bitnet" and mesh.shape["fsdp"] > 1:
        # route bitnet linears through the 2-bit quantized all-gather.
        # The mesh rides the weight wrappers as static metadata, so it
        # must be threaded BEFORE init_train_state (the optimizer state
        # mirrors the wrapper pytrees, metadata included).
        from quantized_training_tpu.parallel import bitnet_fsdp_params

        qparams = bitnet_fsdp_params(qparams, mesh)
    state = init_train_state(qparams, optimizer)
    if mesh is not None:
        state = shard_state(state, mesh)
    step_fn = make_train_step(
        cfg, optimizer, clip_grad_norm=args.clip_grad_norm, mesh=mesh
    )

    save_dir = Path(args.save_dir) / (
        f"{datetime.now().strftime('%Y%m%d_%H%M%S')}_{args.run_name}"
    )
    logger = MetricLogger(save_dir)
    with open(save_dir / "args.json", "w") as f:
        json.dump(vars(args), f, indent=2, default=str)

    step = 0
    if args.resume is not None:
        from quantized_training_tpu.parallel import (
            bitnet_fsdp_params,
            state_shardings,
        )
        from quantized_training_tpu.utils import materialize, restore_sharded

        ckpt = load_checkpoint(args.resume)
        if args.quantize == "bitnet":
            # checkpoints serialize BitNetWeight with mesh=None (a Mesh
            # holds unpicklable Device objects); re-thread the live mesh
            # so the loaded treedef matches state_shardings' treedef
            ckpt["state"] = bitnet_fsdp_params(ckpt["state"], mesh)
        if mesh is not None:
            # shard-by-shard restore: cross-host FSDP shards are placed on
            # their devices directly, never gathered to one host
            state = restore_sharded(ckpt["state"], state_shardings(state, mesh))
        else:
            state = jax.tree.map(jnp.asarray, materialize(ckpt["state"]))
        dloader.load_state_dict(ckpt["dloader"])
        step = ckpt["meta"]["step"]
        print(f"Resumed from {args.resume} at step {step}")

    dloader_iter = iter(dloader)

    def next_batch():
        if args.gradient_accumulation > 1:
            toks, labs = zip(
                *[next(dloader_iter) for _ in range(args.gradient_accumulation)]
            )
            tokens, labels = np.stack(toks), np.stack(labs)
        else:
            tokens, labels = next(dloader_iter)
        if mesh is not None:
            return shard_batch((tokens, labels), mesh)
        return jnp.asarray(tokens), jnp.asarray(labels)

    def lr_at(step):
        return lr_schedule.get_lr(step) if lr_schedule else args.lr

    def key_at(step):
        return jax.random.fold_in(key, 1_000_000 + step)

    summary = dict(losses=[], step_ms=[])
    batch = None
    if step < args.n_steps:
        # compile ahead of the loop: compile time and the step's memory
        # plan are reported apart from the steps
        batch = next_batch()
        t0 = time.perf_counter()
        step_fn = step_fn.lower(state, *batch, lr_at(step), key_at(step)).compile()
        summary["compile_s"] = time.perf_counter() - t0
        plan = step_fn.memory_analysis()
        if plan is not None:
            summary["memory_analysis"] = {
                k: getattr(plan, k)
                for k in ("argument_size_in_bytes", "output_size_in_bytes",
                          "alias_size_in_bytes", "temp_size_in_bytes")
            }
        print(f"compiled train step in {summary['compile_s']:.1f} s; "
              f"memory plan {summary.get('memory_analysis')}")

    if args.profile:
        jax.profiler.start_trace(str(save_dir / "trace"))

    losses = []
    time0, logged = time.perf_counter(), step
    tokens_per_batch = args.batch_size * args.seq_len
    while step < args.n_steps:
        tokens, labels = batch if batch is not None else next_batch()
        batch = None
        lr = lr_at(step)
        state, metrics = step_fn(state, tokens, labels, lr, key_at(step))
        losses.append(metrics["loss"])
        step += 1

        if step % args.log_interval == 0 or step == args.n_steps:
            jax.block_until_ready(metrics["loss"])
            time1 = time.perf_counter()
            n, logged = step - logged, step
            summary["step_ms"].append((time1 - time0) / n * 1e3)
            mem = jax.devices()[0].memory_stats() or {}
            log = dict(
                loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]),
                lr=lr,
                tokens_per_second=tokens_per_batch * n / (time1 - time0),
                num_tokens_seen_millions=tokens_per_batch * step / 1e6,
                peak_memory_gb=(mem.get("peak_bytes_in_use", 0)) / 1e9,
            )
            time0 = time1
            logger.log(log, step)
            print(f"step {step}: " + " ".join(f"{k}={v:.4g}" for k, v in log.items()))

        if args.ckpt_interval > 0 and step % args.ckpt_interval == 0:
            save_checkpoint(
                save_dir / "last.pkl",
                {
                    "state": state,
                    "dloader": dloader.state_dict(),
                    "meta": {"step": step, "args": vars(args)},
                },
            )

        if args.hellaswag and step % args.hellaswag_interval == 0:
            from hellaswag import evaluate_hellaswag

            acc = evaluate_hellaswag(
                quant.merge_masters(quant.virtual_params(state.params), state.params),
                cfg,
                args.hellaswag_tokenizer,
            )
            logger.log(dict(hellaswag_acc=acc), step)
            print(f"step {step}: hellaswag_acc={acc:.4f}")

    if args.profile:
        jax.profiler.stop_trace()
        print(f"profile trace written to {save_dir / 'trace'}")
    logger.finish()
    print(f"done; artifacts in {save_dir}")
    summary["losses"] = [float(l) for l in losses]
    summary["peak_bytes_in_use"] = (
        jax.devices()[0].memory_stats() or {}
    ).get("peak_bytes_in_use")
    summary["save_dir"] = str(save_dir)
    return summary


if __name__ == "__main__":
    main()
