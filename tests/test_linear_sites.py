"""The quantized linear sites of the models — norm -> shared-input q/k/v,
the SwiGLU MLP, ViT's layer-norm -> qkv and gelu -> fc2 — forward and both
gradients against fp32 autodiff of the same function on unquantized
weights, across the int8 mixed-precision configs.

Each site is the plain composite (norm or activation, then
``qlinear_multi`` / ``qlinear``); XLA fuses the producer into the
quantize. int8 row-wise quantization of both operands keeps each product
within ~1 % (relative L2); stochastic rounding adds noise of the same
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantized_training_tpu.models import llama, vit
from quantized_training_tpu.quant import MixedPrecisionConfig, MixedPrecisionWeight, qlinear

CFG = llama.LlamaConfig(hidden_size=128, intermediate_size=256, num_attention_heads=4,
                        num_key_value_heads=2, vocab_size=256, num_hidden_layers=1)
B, S, D, F = 2, 64, 128, 256

CONFIGS = {
    "int8-all": MixedPrecisionConfig(),
    "int8-fwd": MixedPrecisionConfig(grad_input=False, grad_weight=False),
    "int8-fwd-gi": MixedPrecisionConfig(grad_weight=False),
    "int8-all-sr": MixedPrecisionConfig(stochastic_rounding=True),
}


def llama_qkv(x, ws, wrap):
    cos, sin = llama.rope_tables(CFG, S)
    lp = {"attn_norm": {"g": jnp.ones((D,), x.dtype)},
          "q": {"w": wrap(ws[0])}, "k": {"w": wrap(ws[1])}, "v": {"w": wrap(ws[2])}}
    q, k, v = llama._qkv_part(CFG, x, lp, cos, sin, jax.random.PRNGKey(0))
    return jnp.concatenate([t.reshape(B, S, -1) for t in (q, k, v)], axis=-1)


def llama_mlp(x, ws, wrap):
    lp = {"mlp_norm": {"g": jnp.ones((D,), x.dtype)}, "gate": {"w": wrap(ws[0])},
          "up": {"w": wrap(ws[1])}, "down": {"w": wrap(ws[2])}}
    return llama._mlp(CFG, x, lp, jax.random.PRNGKey(1))


def vit_ln_qkv(x, ws, wrap):
    h = vit.layer_norm(x, jnp.ones((D,), x.dtype), jnp.zeros((D,), x.dtype), 1e-6)
    return qlinear(h, wrap(ws[0]), jnp.zeros((3 * D,), x.dtype), key=jax.random.PRNGKey(2))


def vit_gelu_fc2(x, ws, wrap):
    return qlinear(jax.nn.gelu(x), wrap(ws[0]), jnp.zeros((D,), x.dtype),
                   key=jax.random.PRNGKey(3))


SITES = {
    "llama-norm-qkv": (llama_qkv, [(D, D), (D // 2, D), (D // 2, D)], D),
    "llama-mlp": (llama_mlp, [(F, D), (F, D), (D, F)], D),
    "vit-ln-qkv": (vit_ln_qkv, [(3 * D, D)], D),
    "vit-gelu-fc2": (vit_gelu_fc2, [(D, F)], F),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("config", CONFIGS, ids=list(CONFIGS))
@pytest.mark.parametrize("site", SITES, ids=list(SITES))
def test_site_forward_and_grads(site, config):
    fn, w_shapes, d_in = SITES[site]
    keys = jax.random.split(jax.random.PRNGKey(10), len(w_shapes) + 2)
    x = jax.random.normal(keys[0], (B, S, d_in), jnp.float32)
    ws = [jax.random.normal(k, s, jnp.float32) * s[1] ** -0.5
          for k, s in zip(keys[2:], w_shapes)]
    cfg = CONFIGS[config]

    def run(x, ws, wrap, dtype):
        out = fn(x.astype(dtype), [w.astype(dtype) for w in ws], wrap)
        return out.astype(jnp.float32)

    r = jax.random.normal(keys[1], run(x, ws, lambda w: w, jnp.float32).shape)

    def loss(x, ws, wrap, dtype):
        out = run(x, ws, wrap, dtype)
        return jnp.sum(out * r), out

    (_, out), (gx, gw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        x, ws, lambda w: MixedPrecisionWeight(w, cfg), jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        (_, ref), (rgx, rgw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            x, ws, lambda w: w, jnp.float32)
    tol = 6e-2 if cfg.stochastic_rounding else 3e-2
    assert _rel(out, ref) < tol
    assert _rel(gx, rgx) < tol
    for g, rg in zip(gw, rgw):
        assert _rel(g, rg) < tol
