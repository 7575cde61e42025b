"""Fused (chunked) linear + cross-entropy — the LM-head loss hot path.

The reference computes ``F.cross_entropy(logits.float(), labels)`` on fully
materialized logits (llm_pretrain.py:30-35). At Llama vocab (32k) and bench
batch (16k tokens) that costs a [T, V] bf16 logits buffer (1 GB), an fp32
log-softmax residual for the backward (2 GB held across the whole backward),
and an fp32 dlogits materialization (2 GB) — ~3 GB of peak HBM and several
GB of avoidable traffic.

Design: scan over token chunks; per chunk compute the
logits tile [C, V] with fp32 accumulation straight off the GEMM, reduce it
to (logsumexp, label-logit) immediately, and keep only a per-token fp32
``lse`` [T] as the backward residual. The backward re-computes each logits
tile (cheap GEMM work), forms the softmax gradient in-register, and
contracts it into dx / dw per chunk. Peak extra memory is ONE [C, V] tile.

This is the standard "chunked cross entropy" / Liger-style fusion expressed
as XLA-friendly scan + dots rather than a handwritten kernel — the tiles
are large matmuls and XLA fuses the row-reductions into the tile
consumer, so a Pallas version buys nothing further.

Returns (nll_sum, valid_count) so the caller owns the mean convention
(labels == ignore_index are masked out, the finetune-driver contract).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

Array = jax.Array

IGNORE_INDEX = -100


def _pick_chunk(T: int, target: int = 4096) -> int:
    """Largest divisor of T that is <= target and a multiple of 128;
    0 when none exists (caller falls back to the unchunked path)."""
    best = 0
    for c in range(128, min(T, target) + 1, 128):
        if T % c == 0:
            best = c
    return best


def _chunk_fwd(x_c: Array, w: Array, labels_c: Array):
    """One chunk: returns (lse [C] f32, label_logit [C] f32)."""
    logits = jax.lax.dot_general(
        x_c, w, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )  # [C, V] f32
    m = jnp.max(logits, axis=-1)
    lse = m + jnp.log(jnp.sum(jnp.exp(logits - m[:, None]), axis=-1))
    safe = jnp.clip(labels_c, 0, w.shape[0] - 1)
    label_logit = jnp.take_along_axis(logits, safe[:, None], axis=-1)[:, 0]
    return lse, label_logit


@partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def fused_linear_cross_entropy(
    x: Array,
    w: Array,
    labels: Array,
    ignore_index: int = IGNORE_INDEX,
    chunk_target: int = 4096,
):
    """sum of per-token NLL of ``softmax(x @ w.T)`` + valid-token count.

    x: [T, D] activations (bf16), w: [V, D] LM head, labels: [T] int32.
    Tokens with ``labels == ignore_index`` contribute zero loss/grad.
    Returns (nll_sum f32 scalar, n_valid f32 scalar).
    """
    out, _ = _fle_fwd(x, w, labels, ignore_index, chunk_target)
    return out


def _scan_chunks(x: Array, labels: Array, C: int, body):
    T = x.shape[0]
    xs = x.reshape(T // C, C, x.shape[1])
    ls = labels.reshape(T // C, C)
    return jax.lax.scan(body, None, (xs, ls))


def _fle_fwd(x, w, labels, ignore_index, chunk_target):
    T, D = x.shape
    C = _pick_chunk(T, chunk_target)
    if C == 0:
        C = T  # single chunk

    def body(_, inp):
        x_c, l_c = inp
        lse, label_logit = _chunk_fwd(x_c, w, l_c)
        valid = (l_c != ignore_index).astype(jnp.float32)
        nll = (lse - label_logit) * valid
        return None, (jnp.sum(nll), jnp.sum(valid), lse)

    _, (nll_c, valid_c, lse) = _scan_chunks(x, labels, C, body)
    out = (jnp.sum(nll_c), jnp.sum(valid_c))
    return out, (x, w, labels, lse.reshape(T))


def _fle_bwd(ignore_index, chunk_target, res, g):
    x, w, labels, lse = res
    g_nll, _ = g  # no gradient flows through the valid count
    T, D = x.shape
    V = w.shape[0]
    C = _pick_chunk(T, chunk_target)
    if C == 0:
        C = T

    def body(dw_acc, inp):
        x_c, l_c, lse_c = inp
        logits = jax.lax.dot_general(
            x_c, w, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
        )
        p = jnp.exp(logits - lse_c[:, None])  # softmax [C, V]
        valid = (l_c != ignore_index).astype(jnp.float32)
        safe = jnp.clip(l_c, 0, V - 1)
        onehot = jax.nn.one_hot(safe, V, dtype=jnp.float32)
        dl = (p - onehot) * (valid * g_nll)[:, None]
        dl = dl.astype(x.dtype)  # bf16 operand for the contractions
        dx_c = jax.lax.dot_general(
            dl, w, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
        ).astype(x.dtype)
        # dw += dl.T @ x_c, transpose-free (contract both over the token dim)
        dw_c = jax.lax.dot_general(
            dl, x_c, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
        )
        return dw_acc + dw_c, dx_c

    xs = x.reshape(T // C, C, D)
    ls = labels.reshape(T // C, C)
    lses = lse.reshape(T // C, C)
    dw, dx = jax.lax.scan(body, jnp.zeros((V, D), jnp.float32), (xs, ls, lses))
    return dx.reshape(T, D), dw.astype(w.dtype), None


fused_linear_cross_entropy.defvjp(_fle_fwd, _fle_bwd)
