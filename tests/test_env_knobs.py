"""Env-knob matrix smoke.

QT_PREQUANT (per-step weight pre-quantization: 'both' | 'row' | 'col')
is the one environment knob left. Each mode runs through a tiny
mixed-precision train step with and without activation checkpointing, and
the loss must stay finite and close to the default path (same absmax
quantize of the same weights, hoisted out of the layer loop).

The knob is read at trace time; each case builds a fresh step function.
"""

import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent.parent))

from quantized_training_tpu import optim, quant
from quantized_training_tpu.models import llama
from quantized_training_tpu.train import init_train_state, make_train_step

TINY = llama.LlamaConfig(
    vocab_size=512,
    hidden_size=128,
    intermediate_size=256,
    num_hidden_layers=2,
    num_attention_heads=2,
    num_key_value_heads=2,
    max_position_embeddings=64,
)

CASES = [
    ({"QT_PREQUANT": mode}, remat)
    for mode in ("both", "row", "col")
    for remat in (False, True)
]


def _losses(env, remat=False):
    old = os.environ.get("QT_PREQUANT")
    os.environ.update(env)
    try:
        cfg = dataclasses.replace(TINY, remat=remat)
        params = llama.init_params(jax.random.PRNGKey(1), cfg)
        qp = quant.quantize_params(params, "mixed_precision")
        opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
        state = init_train_state(qp, opt)
        step = make_train_step(cfg, opt, donate=False)
        tok = jax.random.randint(
            jax.random.PRNGKey(0), (2, 64), 0, 512, jnp.int32
        )
        lab = jnp.roll(tok, -1, axis=-1)
        out = []
        for i in range(3):
            state, m = step(state, tok, lab, 1e-3, jax.random.PRNGKey(i))
            out.append(float(m["loss"]))
        return out
    finally:
        if old is None:
            os.environ.pop("QT_PREQUANT", None)
        else:
            os.environ["QT_PREQUANT"] = old


@pytest.fixture(scope="module")
def default_losses():
    return _losses({})


@pytest.mark.parametrize("env,remat", CASES, ids=lambda c: (
    f"PREQUANT={c['QT_PREQUANT']}" if isinstance(c, dict) else f"remat={c}"))
def test_knob_matrix_tracks_default(default_losses, env, remat):
    got = _losses(env, remat)
    assert all(np.isfinite(got)), (env, got)
    # same quantization numerics: prequant hoists the same absmax quantize
    np.testing.assert_allclose(got, default_losses, rtol=2e-2)
