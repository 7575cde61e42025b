"""Pure-JAX Llama for quantized pretraining/finetuning.

A re-design of the reference's model path (the reference uses HF
``LlamaForCausalLM``, llm_pretrain.py:100-120): a functional param-pytree
model whose decoder stack runs under ``lax.scan`` (one compiled layer body,
stacked [L, ...] weights — this is also what makes per-layer FSDP sharding
and quantized-wrapper stacking free).

Parity details kept from the reference training setup:
  - RoPE tables in fp32, rotation in the model dtype
    (llm_pretrain.py:115-119 keeps ``rotary_emb.inv_freq`` fp32; HF
    LlamaRotaryEmbedding applies cos/sin in the activation dtype)
  - RMSNorm computes in fp32, scales in the weight dtype (HF LlamaRMSNorm)
  - fp32 softmax in attention; logits cast to fp32 for the loss
    (llm_pretrain.py:30-35)
  - ``bitnet=True`` reproduces the RMSNorm-into-linear surgery of
    train_utils.py:47-71: q/k/v and gate/up consume the existing pre-norms
    and NEW norms are inserted before o_proj and down_proj
  - config loadable from the mini_llamas HF-format config.json
    (mini_llamas/Llama-2-470m/config.json)

Every linear weight leaf lives under a dict key ``"w"`` with shape
[out, in] (stacked: [L, out, in]) so ``quant.quantize_params`` wraps them.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..quant import prequantize_step, qlinear, qlinear_multi

Array = jax.Array


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    bitnet: bool = False  # RMSNorm-into-linear surgery (train_utils.py:47-71)
    remat: bool = False  # activation checkpointing per decoder layer

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_json(cls, path_or_dict, **overrides) -> "LlamaConfig":
        """Load from an HF-format config.json (the mini_llamas contract)."""
        if isinstance(path_or_dict, (str, Path)):
            with open(Path(path_or_dict) / "config.json" if Path(path_or_dict).is_dir() else path_or_dict) as f:
                d = json.load(f)
        else:
            d = dict(path_or_dict)
        keys = {
            "vocab_size",
            "hidden_size",
            "intermediate_size",
            "num_hidden_layers",
            "num_attention_heads",
            "num_key_value_heads",
            "max_position_embeddings",
            "rms_norm_eps",
            "rope_theta",
            "tie_word_embeddings",
        }
        kwargs = {k: v for k, v in d.items() if k in keys}
        kwargs.update(overrides)
        return cls(**kwargs)


# Llama-2-470m (mini_llamas/Llama-2-470m/config.json)
LLAMA2_470M = LlamaConfig()
# Llama2-1B: the README throughput-benchmark model (README.md:123-128 uses
# a 1B llama at bs16/seq2048); standard 1.1B TinyLlama geometry.
LLAMA2_1B = LlamaConfig(
    hidden_size=2048,
    intermediate_size=5632,
    num_hidden_layers=22,
    num_attention_heads=32,
    num_key_value_heads=4,
)


def init_params(key: Array, cfg: LlamaConfig, dtype=jnp.bfloat16):
    """HF-style init: normal(0.02) for weights, ones for norms."""
    H, D = cfg.num_attention_heads * cfg.head_dim, cfg.hidden_size
    KV = cfg.num_key_value_heads * cfg.head_dim
    F, L, V = cfg.intermediate_size, cfg.num_hidden_layers, cfg.vocab_size

    keys = iter(jax.random.split(key, 16))

    def w(k, shape):
        return (jax.random.normal(k, shape, jnp.float32) * 0.02).astype(dtype)

    # separate q/k/v and gate/up projections: the shared input is
    # quantized once for each group (quant.qlinear_multi)
    layers = {
        "attn_norm": {"g": jnp.ones((L, D), dtype)},
        "q": {"w": w(next(keys), (L, H, D))},
        "k": {"w": w(next(keys), (L, KV, D))},
        "v": {"w": w(next(keys), (L, KV, D))},
        "o": {"w": w(next(keys), (L, D, H))},
        "mlp_norm": {"g": jnp.ones((L, D), dtype)},
        "gate": {"w": w(next(keys), (L, F, D))},
        "up": {"w": w(next(keys), (L, F, D))},
        "down": {"w": w(next(keys), (L, D, F))},
    }
    if cfg.bitnet:
        layers["o_norm"] = {"g": jnp.ones((L, H), dtype)}
        layers["down_norm"] = {"g": jnp.ones((L, F), dtype)}

    params = {
        "embed": {"embedding": w(next(keys), (V, D))},
        "layers": layers,
        "final_norm": {"g": jnp.ones((D,), dtype)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": w(next(keys), (V, D))}
    return params


@jax.named_scope("norm")
def rms_norm(x: Array, g: Array, eps: float) -> Array:
    """fp32 math, weight applied in its own dtype (HF LlamaRMSNorm)."""
    xf = x.astype(jnp.float32)
    xf = xf * jax.lax.rsqrt(jnp.mean(xf * xf, axis=-1, keepdims=True) + eps)
    return xf.astype(x.dtype) * g


def rope_tables(cfg: LlamaConfig, seq_len: int) -> tuple[Array, Array]:
    """fp32 cos/sin tables [S, head_dim]."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (
        cfg.rope_theta ** (jnp.arange(0, hd, 2, dtype=jnp.float32) / hd)
    )
    t = jnp.arange(seq_len, dtype=jnp.float32)
    freqs = jnp.outer(t, inv_freq)  # [S, hd/2]
    emb = jnp.concatenate([freqs, freqs], axis=-1)
    return jnp.cos(emb), jnp.sin(emb)


@jax.named_scope("rope")
def apply_rope(x: Array, cos: Array, sin: Array) -> Array:
    """x: [B, S, H, hd]; rotate-half convention.

    Tables are computed in fp32 (rope_tables) and cast to the activation
    dtype here; the rotation itself runs in x's dtype — the HF Llama
    convention (`(q * cos) + (rotate_half(q) * sin)` in model dtype with
    fp32-derived cos/sin).
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = jnp.concatenate([-x2, x1], axis=-1)
    c = cos[None, :, None, :].astype(x.dtype)
    s = sin[None, :, None, :].astype(x.dtype)
    return x * c + rotated * s


_ATTENTION_BY_PLATFORM = {"gpu": "cudnn", "cpu": "xla"}


def attention_implementation() -> str:
    """The attention kernel for this process's platform: cuDNN's fused
    flash attention on the GPU, XLA's einsum composite on the CPU. The one
    platform decision of the model; an unknown platform is an error."""
    platform = jax.default_backend()
    if platform not in _ATTENTION_BY_PLATFORM:
        raise RuntimeError(f"no attention implementation for platform {platform!r}")
    return _ATTENTION_BY_PLATFORM[platform]


def _attention_spec(mesh, batch: int, kv_heads: int) -> P:
    """How [B, S, heads, hd] splits over the mesh: batch over 'data' x
    'fsdp', heads over 'model' (tensor parallelism); a dim the axes do not
    divide stays whole."""
    axes = tuple(a for a in ("data", "fsdp") if mesh.shape.get(a, 1) > 1)
    n_batch = 1
    for a in axes:
        n_batch *= mesh.shape[a]
    n_model = mesh.shape.get("model", 1)
    return P(
        axes if axes and batch % n_batch == 0 else None,
        None,
        "model" if n_model > 1 and kv_heads % n_model == 0 else None,
        None,
    )


@jax.named_scope("attention")
def attention(q: Array, k: Array, v: Array, impl: str | None = None) -> Array:
    """Causal GQA attention, q [B, S, H, hd], k/v [B, S, KV, hd] ->
    [B, S, H, hd].

    ``jax.nn.dot_product_attention`` takes K/V with their own KV heads
    (no repeat). ``impl`` (default: the platform's, see
    attention_implementation) 'cudnn' is the fused flash kernel (a shape
    or dtype it refuses is an error, not a fallback); 'xla' computes fp32
    scores and softmax, P rounded to the activation dtype before PV.

    Under a multi-device mesh context (``jax.sharding.use_abstract_mesh``,
    set by ``make_train_step(mesh=...)`` and ``generate(mesh=...)``) the
    kernel runs per shard in ``shard_map``: attention is local to a batch
    row and a KV-head group, so no collective is needed, and each shard
    hands the kernel its own contiguous K/V.
    """
    if impl is None:
        impl = attention_implementation()
    f = partial(jax.nn.dot_product_attention, is_causal=True, implementation=impl)
    mesh = jax.sharding.get_abstract_mesh()
    if mesh.empty or mesh.size == 1:
        return f(q, k, v)
    spec = _attention_spec(mesh, q.shape[0], k.shape[2])
    # check_vma=False: the cuDNN kernel's custom_vjp does not track which
    # mesh axes its values vary over
    return jax.shard_map(
        f, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False
    )(q, k, v)


def attention_ref(q: Array, k: Array, v: Array) -> Array:
    """fp32 reference for :func:`attention`: K/V heads repeated, every
    product at full precision."""
    S, hd = q.shape[1], q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    q, k, v = (t.astype(jnp.float32) for t in (q, k, v))
    k = jnp.repeat(k, rep, axis=2)
    v = jnp.repeat(v, rep, axis=2)
    scores = jnp.einsum("bshd,bthd->bhst", q, k, precision="highest") * hd**-0.5
    scores = jnp.where(jnp.tril(jnp.ones((S, S), bool)), scores, -jnp.inf)
    probs = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bhst,bthd->bshd", probs, v, precision="highest")


def _qkv_part(cfg: LlamaConfig, x, lp, cos, sin, key):
    """Norm + QKV projections (one quantize of the shared input) + RoPE."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"]["g"], cfg.rms_norm_eps)
    q, k, v = qlinear_multi(
        h, [lp["q"]["w"], lp["k"]["w"], lp["v"]["w"]],
        key=jax.random.fold_in(key, 0),
    )
    q = apply_rope(q.reshape(B, S, H, hd), cos, sin)
    k = apply_rope(k.reshape(B, S, KV, hd), cos, sin)
    return q, k, v.reshape(B, S, KV, hd)


def _mlp(cfg: LlamaConfig, x, lp, key):
    """Pre-norm SwiGLU MLP: norm -> (gate, up) sharing one quantize of
    their input -> silu(gate) * up -> down (BitNet: normed before down)."""
    h = rms_norm(x, lp["mlp_norm"]["g"], cfg.rms_norm_eps)
    gate, up = qlinear_multi(
        h, [lp["gate"]["w"], lp["up"]["w"]], key=jax.random.fold_in(key, 0)
    )
    with jax.named_scope("silu_mul"):
        act = jax.nn.silu(gate) * up
    if cfg.bitnet:
        act = rms_norm(act, lp["down_norm"]["g"], cfg.rms_norm_eps)
    return qlinear(act, lp["down"]["w"], key=jax.random.fold_in(key, 1))


def _decoder_layer(cfg: LlamaConfig, x, lp, cos, sin, key):
    """One decoder layer. lp = per-layer param slice; key for SR quant."""
    B, S, _ = x.shape
    q, k, v = _qkv_part(cfg, x, lp, cos, sin, key)
    ctx = attention(q, k, v).reshape(B, S, -1)
    if cfg.bitnet:
        ctx = rms_norm(ctx, lp["o_norm"]["g"], cfg.rms_norm_eps)
    x = x + qlinear(ctx, lp["o"]["w"], key=jax.random.fold_in(key, 3))
    return x + _mlp(cfg, x, lp, jax.random.fold_in(key, 4))


def backbone(params, tokens: Array, cfg: LlamaConfig, key: Array | None = None):
    """tokens [B, S] int32 -> final-norm hidden states [B, S, D].

    ``key`` seeds stochastic rounding inside quantized linears (unused for
    deterministic schemes).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    B, S = tokens.shape
    x = params["embed"]["embedding"][tokens]
    cos, sin = rope_tables(cfg, S)

    # optional (QT_PREQUANT env var, default off): int8 mixed-precision
    # weights quantized once per step instead of per matmul
    layers = prequantize_step(
        params["layers"], key=jax.random.fold_in(key, 0x5EED)
    )

    layer_body = partial(_decoder_layer, cfg)
    if cfg.remat:
        # per-layer activation checkpointing (llm_pretrain.py:112-113):
        # only the layer input is saved; the backward recomputes the rest
        layer_body = jax.checkpoint(layer_body)

    def scan_fn(x, inputs):
        lp, lkey = inputs
        return layer_body(x, lp, cos, sin, lkey), None

    layer_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(cfg.num_hidden_layers)
    )
    x, _ = jax.lax.scan(scan_fn, x, (layers, layer_keys))

    return rms_norm(x, params["final_norm"]["g"], cfg.rms_norm_eps)


def _lm_head_weight(params, cfg: LlamaConfig):
    return (
        params["embed"]["embedding"]
        if cfg.tie_word_embeddings
        else params["lm_head"]["w"]
    )


def forward(params, tokens: Array, cfg: LlamaConfig, key: Array | None = None):
    """tokens [B, S] int32 -> logits [B, S, V] (model dtype; cast for loss)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    x = backbone(params, tokens, cfg, key)
    lm_w = _lm_head_weight(params, cfg)
    return qlinear(x, lm_w, key=jax.random.fold_in(key, 0x7FFFFFFF))


def loss_fn(params, tokens: Array, labels: Array, cfg: LlamaConfig, key=None):
    """fp32 token-mean cross entropy (llm_pretrain.py:30-35).

    labels == -100 are ignored (the padding convention of the finetune
    driver, llm_finetune.py).

    When the LM head is a plain (unquantized) weight the logits never
    materialize: the head matmul and the softmax/NLL run chunk-fused
    (ops/cross_entropy.py), saving the [T, V] fp32 log-softmax residual
    and dlogits buffers (~3 GB at bench shapes). A quantized LM head
    (--quantize_lm_head) falls back to explicit logits so the quantized
    matmul semantics are preserved.
    """
    lm_w = _lm_head_weight(params, cfg)
    if isinstance(lm_w, jax.Array):
        from ..ops.cross_entropy import fused_linear_cross_entropy

        x = backbone(params, tokens, cfg, key)
        x2d = x.reshape(-1, x.shape[-1])
        with jax.named_scope("loss"):
            nll_sum, n_valid = fused_linear_cross_entropy(
                x2d, lm_w, labels.reshape(-1)
            )
        return nll_sum / jnp.maximum(n_valid, 1)

    logits = forward(params, tokens, cfg, key).astype(jnp.float32)
    V = logits.shape[-1]
    logits = logits.reshape(-1, V)
    labels = labels.reshape(-1)
    valid = labels != -100
    safe_labels = jnp.where(valid, labels, 0)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, safe_labels[:, None], axis=-1)[:, 0]
    nll = jnp.where(valid, nll, 0.0)
    return nll.sum() / jnp.maximum(valid.sum(), 1)


def num_params(params) -> int:
    import numpy as np

    leaves = jax.tree.leaves(params)
    return int(sum(np.prod(l.shape) for l in leaves))
