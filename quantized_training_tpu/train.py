"""Jitted training step assembly.

The functional equivalent of the reference train loop body
(llm_pretrain.py:190-258): one ``train_step`` closes over model config and
optimizer and performs

  virtual_params -> value_and_grad(merge_masters -> loss)
  -> [grad accumulation via lax.scan] -> clip -> optimizer.step
  -> commit_params (SR re-quantization of quantized storage)

entirely under ``jax.jit`` with donated state (the torch.compile +
in-place-optimizer equivalent, fused into a single XLA program).

Distribution: pass ``mesh`` + axis names and the step is pjit-sharded —
data-parallel over 'data', parameter-sharded (FSDP) over 'fsdp'
(see parallel/).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from .models import llama
from .optim.adamw import Optimizer
from .quant import commit_params, merge_masters, virtual_params
from .utils.train import clip_by_global_norm, global_norm

Array = jax.Array


class TrainState(NamedTuple):
    params: Any  # storage tree (may contain quantized wrappers)
    opt_state: Any
    step: Array  # scalar int32


def init_train_state(params, optimizer: Optimizer) -> TrainState:
    vparams = virtual_params(params)
    return TrainState(params, optimizer.init(vparams), jnp.zeros((), jnp.int32))


def make_train_step(
    cfg: llama.LlamaConfig,
    optimizer: Optimizer,
    clip_grad_norm: float | None = None,
    donate: bool = True,
    jit_compile: bool = True,
    mesh=None,
):
    """Returns jitted ``step(state, tokens, labels, lr, key) ->
    (state, metrics)``.

    tokens/labels: [B, S] or [accum, B, S] for gradient accumulation
    (micro-steps run under lax.scan; grads are averaged, matching the
    reference's loss.backward() accumulation + mean loss).

    ``mesh``: when given, the output state is sharding-constrained to the
    FSDP param rule (parallel.state_shardings). Without this XLA may
    propagate a different layout for small leaves (e.g. stacked [L, D]
    norm params come back dim-1-sharded), which silently diverges from
    the layout ``shard_state`` documents — and under a multi-process
    mesh that breaks the file-per-rank checkpoint restore, whose target
    shardings come from the param rule. The step is traced under the
    mesh (``jax.sharding.use_abstract_mesh``), so attention runs per shard
    (``llama.attention``): pass it for every sharded step.
    """

    def train_step(state: TrainState, tokens, labels, lr, key):
        if mesh is None:
            return _train_step(state, tokens, labels, lr, key)
        with jax.sharding.use_abstract_mesh(mesh.abstract_mesh):
            return _train_step(state, tokens, labels, lr, key)

    def _train_step(state: TrainState, tokens, labels, lr, key):
        qparams = state.params
        vparams = virtual_params(qparams)

        def loss_fn(v, tok, lab, k):
            merged = merge_masters(v, qparams)
            return llama.loss_fn(merged, tok, lab, cfg, key=k)

        if tokens.ndim == 3:  # [accum, B, S] micro-batches
            n_micro = tokens.shape[0]

            def micro(carry, inp):
                g_acc, loss_acc = carry
                tok, lab, i = inp
                loss, g = jax.value_and_grad(loss_fn)(
                    vparams, tok, lab, jax.random.fold_in(key, i)
                )
                g_acc = jax.tree.map(jnp.add, g_acc, g)
                return (g_acc, loss_acc + loss), None

            # Accumulate in the GRAD dtype (reference semantics: PyTorch
            # .backward() accumulates into param.grad, which is bf16 for
            # bf16 params). An fp32 accumulator would double the scan
            # carry (4.4 GB at 1.1B params); loss-curve parity is covered
            # by test_grad_accumulation_close_to_large_batch.
            zeros = jax.tree.map(
                lambda p: jnp.zeros(p.shape, p.dtype), vparams
            )
            (grads, loss), _ = jax.lax.scan(
                micro,
                (zeros, jnp.zeros((), jnp.float32)),
                (tokens, labels, jnp.arange(n_micro)),
            )
            grads = jax.tree.map(lambda g: g / n_micro, grads)
            loss = loss / n_micro
        else:
            loss, grads = jax.value_and_grad(loss_fn)(
                vparams, tokens, labels, jax.random.fold_in(key, 0)
            )

        if clip_grad_norm is not None:
            grads, grad_norm = clip_by_global_norm(grads, clip_grad_norm)
        else:
            grad_norm = global_norm(grads)

        with jax.named_scope("optimizer"):
            new_v, new_opt = optimizer.step(
                grads, state.opt_state, vparams, lr, jax.random.fold_in(key, 1)
            )
            new_params = commit_params(new_v, qparams, jax.random.fold_in(key, 2))

        metrics = {"loss": loss, "grad_norm": grad_norm}
        new_state = TrainState(new_params, new_opt, state.step + 1)
        if mesh is not None:
            from .parallel import state_shardings

            new_state = jax.lax.with_sharding_constraint(
                new_state, state_shardings(new_state, mesh)
            )
        return new_state, metrics

    if not jit_compile:  # for embedding into larger jitted programs (bench)
        return train_step
    donate_argnums = (0,) if donate else ()
    return jax.jit(train_step, donate_argnums=donate_argnums)


def make_eval_step(cfg: llama.LlamaConfig):
    """Jitted loss-only step for validation perplexity."""

    @jax.jit
    def eval_step(params, tokens, labels):
        return llama.loss_fn(params, tokens, labels, cfg)

    return eval_step
