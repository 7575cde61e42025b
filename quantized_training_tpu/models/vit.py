"""Pure-JAX Vision Transformer for quantized finetuning/training.

The reference uses external timm ViTs (timm_finetune.py:138,
timm_imagenet.py) and quantizes their nn.Linear weights; this is the
equivalent model family with the same quantization surface: every linear
weight leaf lives under a dict key "w" [out, in] so
``quant.quantize_params`` wraps them (patch-embed included; the
CLASSIFIER HEAD is excluded by the default small-linear filter of
quant/api.py. The reference quantizes every nn.Linear including the head,
timm_finetune.py:141 TODO notwithstanding).

Architecture: standard ViT (patch16 / learnable pos-embed / cls token /
pre-LN blocks / GELU MLP), sizes matching timm's vit_{tiny,small,base}
_patch16_224. The patch embedding runs as a reshape + matmul (a conv
whose stride equals its kernel IS a matmul, so no conv is needed).
Encoder blocks run under lax.scan like the Llama stack.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..quant import qlinear

Array = jax.Array


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 192
    num_layers: int = 12
    num_heads: int = 3
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    layer_norm_eps: float = 1e-6
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


VIT_TINY = ViTConfig(hidden_size=192, num_layers=12, num_heads=3)
VIT_SMALL = ViTConfig(hidden_size=384, num_layers=12, num_heads=6)
VIT_BASE = ViTConfig(hidden_size=768, num_layers=12, num_heads=12)
VIT_LARGE = ViTConfig(hidden_size=1024, num_layers=24, num_heads=16)
VIT_HUGE = ViTConfig(hidden_size=1280, num_layers=32, num_heads=16)
# The reference's own finetune target (README.md:64 timm_finetune.py
# --model timm/vit_giant_patch14_dinov2): embed 1536 / depth 40 / heads 24
# / patch 14 (224/14 = 16x16 -> 257 tokens).
VIT_GIANT = ViTConfig(
    patch_size=14, hidden_size=1536, num_layers=40, num_heads=24
)


def init_params(key: Array, cfg: ViTConfig, dtype=jnp.bfloat16):
    D, L = cfg.hidden_size, cfg.num_layers
    P = cfg.patch_size
    mlp = cfg.mlp_dim
    keys = iter(jax.random.split(key, 12))

    def w(k, shape, std=0.02):
        return (jax.random.normal(k, shape, jnp.float32) * std).astype(dtype)

    layers = {
        "norm1": {"g": jnp.ones((L, D), dtype), "b": jnp.zeros((L, D), dtype)},
        "qkv": {"w": w(next(keys), (L, 3 * D, D)), "b": jnp.zeros((L, 3 * D), dtype)},
        "proj": {"w": w(next(keys), (L, D, D)), "b": jnp.zeros((L, D), dtype)},
        "norm2": {"g": jnp.ones((L, D), dtype), "b": jnp.zeros((L, D), dtype)},
        "fc1": {"w": w(next(keys), (L, mlp, D)), "b": jnp.zeros((L, mlp), dtype)},
        "fc2": {"w": w(next(keys), (L, D, mlp)), "b": jnp.zeros((L, D), dtype)},
    }
    return {
        "patch_embed": {
            "w": w(next(keys), (D, 3 * P * P)),
            "b": jnp.zeros((D,), dtype),
        },
        "cls_token": jnp.zeros((1, 1, D), dtype),
        "pos_embed": w(next(keys), (1, cfg.num_patches + 1, D)),
        "layers": layers,
        "final_norm": {"g": jnp.ones((D,), dtype), "b": jnp.zeros((D,), dtype)},
        "head": {"w": w(next(keys), (cfg.num_classes, D)), "b": jnp.zeros((cfg.num_classes,), dtype)},
    }


def layer_norm(x: Array, g: Array, b: Array, eps: float) -> Array:
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    return ((xf - mean) * jax.lax.rsqrt(var + eps)).astype(x.dtype) * g + b


def patchify(images: Array, patch: int) -> Array:
    """NHWC images [B, H, W, 3] -> patches [B, N, 3*P*P]."""
    B, H, W, C = images.shape
    x = images.reshape(B, H // patch, patch, W // patch, patch, C)
    x = x.transpose(0, 1, 3, 2, 4, 5)  # B, h, w, p, p, C
    return x.reshape(B, (H // patch) * (W // patch), patch * patch * C)


def _block(cfg: ViTConfig, x, lp, key):
    B, S, D = x.shape
    H = cfg.num_heads
    hd = D // H

    def lkey(i):
        return jax.random.fold_in(key, i)

    h = layer_norm(x, lp["norm1"]["g"], lp["norm1"]["b"], cfg.layer_norm_eps)
    qkv = qlinear(h, lp["qkv"]["w"], lp["qkv"]["b"], key=lkey(0))
    q, k, v = jnp.split(qkv.reshape(B, S, 3, H, hd), 3, axis=2)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]

    scores = jnp.einsum(
        "bshd,bthd->bhst", q, k, preferred_element_type=jnp.float32
    ) * (hd**-0.5)
    probs = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
    ctx = jnp.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, D)
    x = x + qlinear(ctx, lp["proj"]["w"], lp["proj"]["b"], key=lkey(1))

    h = layer_norm(x, lp["norm2"]["g"], lp["norm2"]["b"], cfg.layer_norm_eps)
    h = qlinear(h, lp["fc1"]["w"], lp["fc1"]["b"], key=lkey(2))
    x = x + qlinear(jax.nn.gelu(h), lp["fc2"]["w"], lp["fc2"]["b"], key=lkey(3))
    return x


def forward(params, images: Array, cfg: ViTConfig, key: Array | None = None):
    """images [B, H, W, 3] (NHWC, normalized) -> logits [B, num_classes]."""
    if key is None:
        key = jax.random.PRNGKey(0)
    B = images.shape[0]
    patches = patchify(images.astype(params["patch_embed"]["w"].dtype), cfg.patch_size)
    x = qlinear(patches, params["patch_embed"]["w"], params["patch_embed"]["b"],
                key=jax.random.fold_in(key, 101))

    cls = jnp.broadcast_to(params["cls_token"], (B, 1, x.shape[-1]))
    x = jnp.concatenate([cls.astype(x.dtype), x], axis=1)
    x = x + params["pos_embed"].astype(x.dtype)

    block = partial(_block, cfg)
    if cfg.remat:
        block = jax.checkpoint(block)

    def scan_fn(x, inputs):
        lp, lkey = inputs
        return block(x, lp, lkey), None

    layer_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(cfg.num_layers)
    )
    x, _ = jax.lax.scan(scan_fn, x, (params["layers"], layer_keys))

    x = layer_norm(x, params["final_norm"]["g"], params["final_norm"]["b"], cfg.layer_norm_eps)
    return qlinear(x[:, 0], params["head"]["w"], params["head"]["b"],
                   key=jax.random.fold_in(key, 102))


def loss_fn(params, images: Array, labels: Array, cfg: ViTConfig, key=None):
    logits = forward(params, images, cfg, key).astype(jnp.float32)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
    return nll.mean()
