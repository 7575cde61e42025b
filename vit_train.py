"""ViT training/finetuning driver (timm_finetune.py + timm_imagenet.py
analog). ``main(argv)`` can be called in-process and returns the run's
summary.

CLI parity: --quantize/--quantize_kwargs, cosine LR with warmup
(timm_finetune.py:24-37), per-epoch validation accuracy
(timm_finetune.py:101-119), images/sec logging. Datasets: streaming HF
image ('hf_image'), tar shards ('wds'), or 'synthetic_image' for
zero-egress runs.

Example:
  python vit_train.py --model vit_tiny --train_ds '{"type":"synthetic_image"}' \
      --quantize mixed_precision --n_steps 50 --batch_size 32 --cpu
"""

from __future__ import annotations

import argparse
import json
import math
import time
from datetime import datetime
from pathlib import Path

import numpy as np


class CosineSchedule:
    """Warmup + cosine decay to 0 (timm_finetune.py:24-37)."""

    def __init__(self, lr: float, total_steps: int, warmup: float = 0.05) -> None:
        self.lr = lr
        self.final_lr = 0.0
        self.total_steps = total_steps
        self.warmup_steps = round(total_steps * warmup)

    def get_lr(self, step: int) -> float:
        if step < self.warmup_steps:
            return self.lr * step / self.warmup_steps
        if step < self.total_steps:
            progress = (step - self.warmup_steps) / (self.total_steps - self.warmup_steps)
            return self.final_lr + 0.5 * (self.lr - self.final_lr) * (
                1 + math.cos(progress * math.pi)
            )
        return self.final_lr


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="vit_tiny",
                        help="vit_tiny|vit_small|vit_base|vit_large|vit_huge|vit_giant")
    parser.add_argument("--model_kwargs", type=json.loads, default=dict())
    parser.add_argument("--num_classes", type=int, default=45)  # RESISC45

    parser.add_argument("--quantize")
    parser.add_argument("--quantize_kwargs", type=json.loads, default=dict())
    parser.add_argument(
        "--quantize_min_k", type=int, default=0,
        help="selective quantization: only quantize linears whose "
        "contraction dim (in_features) is >= this (SwitchBack-style "
        "'only the large matmuls')")

    parser.add_argument("--train_ds", type=json.loads, required=True)
    parser.add_argument("--val_ds", type=json.loads)
    parser.add_argument("--n_steps", type=int, default=1000)
    parser.add_argument("--eval_interval", type=int, default=0)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--image_size", type=int, default=224)

    parser.add_argument("--optim", default="adamw")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--optim_kwargs", type=json.loads, default=dict())
    parser.add_argument("--cosine_lr_scheduler", action="store_true")

    parser.add_argument("--run_name", default="run")
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--log_interval", type=int, default=10)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from quantized_training_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()

    import dataclasses

    import jax.numpy as jnp

    from quantized_training_tpu import optim, quant
    from quantized_training_tpu.data import BatchLoader, get_dataset
    from quantized_training_tpu.models import vit
    from quantized_training_tpu.utils import print_model_stats
    from quantized_training_tpu.utils.logging import MetricLogger

    named = {"vit_tiny": vit.VIT_TINY, "vit_small": vit.VIT_SMALL,
             "vit_base": vit.VIT_BASE, "vit_large": vit.VIT_LARGE,
             "vit_huge": vit.VIT_HUGE, "vit_giant": vit.VIT_GIANT}
    overrides = dict(
        num_classes=args.num_classes,
        image_size=args.image_size,
        remat=True,
    )
    overrides.update(args.model_kwargs)
    cfg = dataclasses.replace(named[args.model], **overrides)
    key = jax.random.PRNGKey(args.seed)
    params = vit.init_params(jax.random.fold_in(key, 0), cfg)
    filter_fn = None
    if args.quantize_min_k:
        from quantized_training_tpu.quant.api import _default_filter

        def filter_fn(path, leaf):
            return (
                _default_filter(path, leaf)
                and leaf.shape[-1] >= args.quantize_min_k
            )

    qparams = quant.quantize_params(
        params, args.quantize, filter_fn=filter_fn, **args.quantize_kwargs
    )
    print_model_stats(params)

    optimizer = optim.get_optimizer(
        args.optim, weight_decay=args.weight_decay, **args.optim_kwargs
    )
    lr_schedule = CosineSchedule(args.lr, args.n_steps) if args.cosine_lr_scheduler else None

    if args.train_ds.get("type") == "synthetic_image":
        args.train_ds.setdefault("num_classes", cfg.num_classes)
        args.train_ds.setdefault("size", cfg.image_size)
    ds = get_dataset(eval=False, **args.train_ds)
    dloader = BatchLoader(ds, batch_size=args.batch_size)

    opt_state = optimizer.init(quant.virtual_params(qparams))

    @jax.jit
    def train_step(qparams, opt_state, images, labels, lr, skey):
        v = quant.virtual_params(qparams)

        def loss(v):
            merged = quant.merge_masters(v, qparams)
            return vit.loss_fn(merged, images, labels, cfg, key=skey)

        l, g = jax.value_and_grad(loss)(v)
        v2, opt_state2 = optimizer.step(g, opt_state, v, lr, jax.random.fold_in(skey, 1))
        qparams2 = quant.commit_params(v2, qparams, jax.random.fold_in(skey, 2))
        return qparams2, opt_state2, l

    @jax.jit
    def predict(qparams, images):
        return jnp.argmax(vit.forward(qparams, images, cfg), axis=-1)

    def evaluate():
        if args.val_ds is None:
            return None
        vds = get_dataset(eval=True, **args.val_ds)
        vloader = BatchLoader(vds, batch_size=args.batch_size)
        correct = total = 0
        for images, labels in vloader:
            preds = predict(qparams, jnp.asarray(images))
            correct += int((np.asarray(preds) == labels).sum())
            total += len(labels)
        return correct / max(total, 1)

    save_dir = Path("runs/vit_train") / (
        f"{datetime.now().strftime('%Y%m%d_%H%M%S')}_{args.run_name}"
    )
    logger = MetricLogger(save_dir)

    summary = dict(losses=[], step_ms=[])
    step = 0
    time0 = time.time()
    dloader_iter = iter(dloader)
    while step < args.n_steps:
        images, labels = next(dloader_iter)
        lr = lr_schedule.get_lr(step) if lr_schedule else args.lr
        qparams, opt_state, loss = train_step(
            qparams,
            opt_state,
            jnp.asarray(images),
            jnp.asarray(labels),
            lr,
            jax.random.fold_in(key, 1_000_000 + step),
        )
        step += 1
        summary["losses"].append(loss)
        if step % args.log_interval == 0 or step == args.n_steps:
            jax.block_until_ready(loss)
            time1 = time.time()
            log = dict(
                loss=float(loss),
                lr=lr,
                images_per_second=args.batch_size
                * min(args.log_interval, step)
                / (time1 - time0),
            )
            summary["step_ms"].append((time1 - time0) / min(args.log_interval, step) * 1e3)
            time0 = time1
            logger.log(log, step)
            print(f"step {step}: " + " ".join(f"{k}={v:.4g}" for k, v in log.items()))

        if args.eval_interval and step % args.eval_interval == 0:
            acc = evaluate()
            if acc is not None:
                logger.log(dict(val_acc=acc), step)
                print(f"step {step}: val_acc={acc:.4f}")

    acc = evaluate()
    if acc is not None:
        print(f"final val_acc={acc:.4f}")
        logger.log(dict(val_acc=acc), step)
    logger.finish()
    print(f"done; artifacts in {save_dir}")
    summary["losses"] = [float(l) for l in summary["losses"]]
    return summary


if __name__ == "__main__":
    main()
