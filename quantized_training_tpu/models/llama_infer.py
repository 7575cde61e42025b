"""Llama inference: INT8 KV-cache prefill/decode + generation loop.

North-star extension beyond the reference (which evaluates through HF
forward passes only, llm_evaluate.py): batched autoregressive inference
running the same scaled dequant+matmul kernels, with the KV cache stored
as row-wise absmax INT8 (one scale per token per head — the same
quantize_int8 primitive as the training path, subclasses/int8.py:13-26),
halving KV memory vs bf16 and 4x vs fp32.

Weights may be any scheme wrapper (Int8Weight/Int4Weight/
BitNetPackedWeight/plain) — the same qlinear dispatch as training.

Decode runs under lax.scan over layers with the cache threaded as scan
ys (functional update), and generation under lax.scan over steps — one
compiled program regardless of length.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..quant import qlinear
from ..quant.core import quantize_int8
from . import llama

Array = jax.Array


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["k", "k_scale", "v", "v_scale"],
    meta_fields=[],
)
@dataclass
class KVCache:
    """INT8 KV cache: [L, B, S_max, KV_heads, head_dim] int8 + per-token
    per-head scales [L, B, S_max, KV_heads, 1]."""

    k: Array
    k_scale: Array
    v: Array
    v_scale: Array

    @classmethod
    def zeros(cls, cfg: llama.LlamaConfig, batch: int, max_len: int, dtype=jnp.bfloat16):
        L = cfg.num_hidden_layers
        KV, hd = cfg.num_key_value_heads, cfg.head_dim
        shape = (L, batch, max_len, KV, hd)
        sshape = (L, batch, max_len, KV, 1)
        return cls(
            jnp.zeros(shape, jnp.int8),
            jnp.zeros(sshape, dtype),
            jnp.zeros(shape, jnp.int8),
            jnp.zeros(sshape, dtype),
        )

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def _quant_kv(x: Array):
    """[B, T, KV, hd] -> int8 + per-(token, head) scale."""
    return quantize_int8(x, axis=-1)


def _attention_over_cache(q, k_c, ks_c, v_c, vs_c, pos):
    """q [B, T, H, hd] against the (already updated) per-layer cache
    slices k/v [B, S, KV, hd] int8 + scales. Returns ctx [B, T, H, hd]."""
    B, T, H, hd = q.shape
    S = k_c.shape[1]
    KV = k_c.shape[2]

    # dequantize the whole cache for attention; masked positions have
    # scale 0 so they contribute zeros pre-mask anyway
    k_deq = k_c.astype(ks_c.dtype) * ks_c  # [B, S, KV, hd]
    v_deq = v_c.astype(vs_c.dtype) * vs_c

    # GQA WITHOUT materializing the head repeat: group the q heads as
    # [B, T, KV, G, hd] and batch the einsum over the KV dim (a jnp.repeat
    # would copy the dequantized cache G times per layer per step)
    G = H // KV
    qg = q.reshape(B, T, KV, G, hd)
    scores = jnp.einsum(
        "btkgd,bskd->bkgts", qg, k_deq, preferred_element_type=jnp.float32
    ) * (hd**-0.5)
    # position t (absolute pos+t) may attend to cache positions <= pos+t
    t_ids = jax.lax.broadcasted_iota(jnp.int32, (T, S), 0) + pos
    s_ids = jax.lax.broadcasted_iota(jnp.int32, (T, S), 1)
    mask = s_ids <= t_ids
    scores = jnp.where(mask[None, None, None], scores, -jnp.inf)
    probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    ctx = jnp.einsum("bkgts,bskd->btkgd", probs, v_deq)
    return ctx.reshape(B, T, H, hd)


def forward_with_cache(
    params,
    tokens: Array,
    cache: KVCache,
    pos,
    cfg: llama.LlamaConfig,
    flash_prefill: bool = True,
):
    """tokens [B, T] at absolute positions pos..pos+T -> (logits [B, T, V],
    updated cache). Used for both prefill (T>1) and decode (T=1).

    The cache rides the layer scan as CARRY and each layer writes only its
    fresh [T]-token rows via dynamic_update_slice — XLA aliases the carry
    buffers, so the cache updates in place (scanning per-layer cache
    slices as scan outputs would copy the entire cache every call).
    """
    B, T = tokens.shape
    x = params["embed"]["embedding"][tokens]
    cos_full, sin_full = llama.rope_tables(cfg, cache.max_len)
    cos = jax.lax.dynamic_slice_in_dim(cos_full, pos, T, axis=0)
    sin = jax.lax.dynamic_slice_in_dim(sin_full, pos, T, axis=0)

    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    # PREFILL fast path (static pos==0): nothing before the fresh tokens
    # exists, so causal attention over the dequantized fresh K/V equals
    # attention over the cache — route it through llama.attention (the
    # fused flash kernel on the GPU) instead of materializing
    # [B, H, T, S] fp32 scores. Attending over dequant(quant(k)) keeps
    # prefill/decode numerics identical (both see the quantized cache).
    # flash_prefill=False takes the cache einsum instead (a plain
    # reference for the kernel).
    use_flash_prefill = (
        flash_prefill and isinstance(pos, int) and pos == 0 and T > 1
    )

    def layer_fn(carry, lp):
        x, k_all, ks_all, v_all, vs_all, l = carry
        h = llama.rms_norm(x, lp["attn_norm"]["g"], cfg.rms_norm_eps)
        q = qlinear(h, lp["q"]["w"]).reshape(B, T, H, hd)
        k = qlinear(h, lp["k"]["w"]).reshape(B, T, KV, hd)
        v = qlinear(h, lp["v"]["w"]).reshape(B, T, KV, hd)
        q = llama.apply_rope(q, cos, sin)
        k = llama.apply_rope(k, cos, sin)

        k_q, k_s = _quant_kv(k)
        v_q, v_s = _quant_kv(v)
        idx = (l, 0, pos, 0, 0)
        k_all = jax.lax.dynamic_update_slice(k_all, k_q[None], idx)
        ks_all = jax.lax.dynamic_update_slice(
            ks_all, k_s.astype(ks_all.dtype)[None], idx
        )
        v_all = jax.lax.dynamic_update_slice(v_all, v_q[None], idx)
        vs_all = jax.lax.dynamic_update_slice(
            vs_all, v_s.astype(vs_all.dtype)[None], idx
        )

        if use_flash_prefill:
            k_deq = (k_q.astype(k_s.dtype) * k_s).astype(q.dtype)
            v_deq = (v_q.astype(v_s.dtype) * v_s).astype(q.dtype)
            ctx = llama.attention(q, k_deq, v_deq)
        else:
            sl = lambda a: jax.lax.dynamic_index_in_dim(a, l, 0, keepdims=False)
            ctx = _attention_over_cache(
                q, sl(k_all), sl(ks_all), sl(v_all), sl(vs_all), pos
            )
        ctx = ctx.reshape(B, T, H * hd)
        if cfg.bitnet:
            ctx = llama.rms_norm(ctx, lp["o_norm"]["g"], cfg.rms_norm_eps)
        x = x + qlinear(ctx, lp["o"]["w"])

        h = llama.rms_norm(x, lp["mlp_norm"]["g"], cfg.rms_norm_eps)
        act = jax.nn.silu(qlinear(h, lp["gate"]["w"])) * qlinear(h, lp["up"]["w"])
        if cfg.bitnet:
            act = llama.rms_norm(act, lp["down_norm"]["g"], cfg.rms_norm_eps)
        x = x + qlinear(act, lp["down"]["w"])
        return (x, k_all, ks_all, v_all, vs_all, l + 1), None

    carry0 = (
        x, cache.k, cache.k_scale, cache.v, cache.v_scale,
        jnp.zeros((), jnp.int32),
    )
    (x, k_all, ks_all, v_all, vs_all, _), _ = jax.lax.scan(
        layer_fn, carry0, params["layers"]
    )
    new_cache = KVCache(k_all, ks_all, v_all, vs_all)

    x = llama.rms_norm(x, params["final_norm"]["g"], cfg.rms_norm_eps)
    lm_w = (
        params["embed"]["embedding"]
        if cfg.tie_word_embeddings
        else params["lm_head"]["w"]
    )
    return qlinear(x, lm_w), new_cache


def prefill(params, prompt: Array, cfg: llama.LlamaConfig, max_len: int, mesh=None):
    """prompt [B, T] at positions 0..T -> (logits [B, T, V], a KV cache of
    ``max_len`` positions holding the prompt).

    ``mesh``: tensor-parallel serving — the cache is sharded over the
    'model' axis (parallel.shard_kv_cache) and attention runs per KV-head
    group under the mesh (llama.attention); pass params through
    parallel.shard_params_tp. Call under ``jax.jit``.
    """
    cache = KVCache.zeros(cfg, prompt.shape[0], max_len)
    if mesh is None:
        return forward_with_cache(params, prompt, cache, 0, cfg)
    from ..parallel import shard_kv_cache

    cache = shard_kv_cache(cache, mesh)
    with jax.sharding.use_abstract_mesh(mesh.abstract_mesh):
        return forward_with_cache(params, prompt, cache, 0, cfg)


def generate(
    params,
    prompt: Array,
    cfg: llama.LlamaConfig,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    key: Array | None = None,
    max_len: int | None = None,
    mesh=None,
):
    """Greedy (temperature=0) or sampled generation.

    prompt [B, T_prompt] int32 -> [B, T_prompt + max_new_tokens].
    One prefill pass + a scanned decode loop, all jittable.

    ``mesh``: tensor-parallel serving (see :func:`prefill`).
    """
    B, T0 = prompt.shape
    max_len = max_len or (T0 + max_new_tokens)
    if key is None:
        key = jax.random.PRNGKey(0)
    logits, cache = prefill(params, prompt, cfg, max_len, mesh)
    last_logits = logits[:, -1].astype(jnp.float32)

    def sample(logits, k):
        if temperature == 0.0:
            return jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return jax.random.categorical(k, logits / temperature, axis=-1).astype(
            jnp.int32
        )

    def step(carry, i):
        cache, last_logits = carry
        tok = sample(last_logits, jax.random.fold_in(key, i))
        logits, cache = forward_with_cache(
            params, tok[:, None], cache, T0 + i, cfg
        )
        return (cache, logits[:, -1].astype(jnp.float32)), tok

    (_, final_logits), toks = jax.lax.scan(
        step, (cache, last_logits), jnp.arange(max_new_tokens)
    )
    return jnp.concatenate([prompt, toks.T], axis=1)
