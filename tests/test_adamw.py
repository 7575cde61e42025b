"""AdamW with bf16 states: the jnp update against a numpy reference, and
the bf16 stochastic-rounding writeback's statistics and determinism."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from quantized_training_tpu import optim


def reference(p, grads, lr, b1=0.9, b2=0.999, eps=1e-8, wd=1e-2):
    """fp32 AdamW whose moments are stored in bf16 between steps."""
    bf16 = lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float32)
    m = np.zeros_like(p)
    v = np.zeros_like(p)
    for t, g in enumerate(grads, start=1):
        m = m + (1 - b1) * (g - m)
        v = v + (1 - b2) * (g * g - v)
        denom = np.sqrt(v) / np.sqrt(1 - b2**t) + eps
        p = p - lr * wd * p - lr * (m / (1 - b1**t)) / denom
        m, v = bf16(m), bf16(v)
    return p


@pytest.mark.parametrize("shape", [(7,), (64, 128), (3, 32, 48), (1000,)])
def test_matches_reference(shape):
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    p0 = np.asarray(jax.random.normal(keys[0], shape), np.float32)
    grads = [np.asarray(jax.random.normal(k, shape), np.float32) for k in keys[1:]]
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    params = {"w": jnp.asarray(p0)}
    state = opt.init(params)
    for g in grads:
        params, state = opt.step({"w": jnp.asarray(g)}, state, params, 1e-2)
    assert state.exp_avg["w"].dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(params["w"]), reference(p0, grads, 1e-2),
                               rtol=1e-5, atol=1e-6)


def _sr_step(key, n=1 << 16):
    """One step from bf16 1.0 whose exact fp32 result lies 0.3 of a bf16
    step below the grid point 1.0."""
    opt = optim.adamw_bf16_sr(weight_decay=0.0)
    lr = 0.3 * 2.0**-8  # first Adam step moves by ~lr; spacing below 1.0 is 2^-8
    params = {"w": jnp.ones((n,), jnp.bfloat16)}
    grads = {"w": jnp.ones((n,), jnp.bfloat16)}
    new, _ = opt.step(grads, opt.init(params), params, lr, key)
    return new["w"], 1.0 - lr / (1 + 1e-8)


def test_sr_writeback_unbiased():
    w, exact = _sr_step(jax.random.PRNGKey(0))
    vals = np.unique(np.asarray(w, np.float32))
    assert set(vals) <= {1.0, 1.0 - 2.0**-8}
    assert abs(float(np.asarray(w, np.float64).mean()) - exact) < 2e-5


def test_sr_writeback_deterministic_in_key():
    a, _ = _sr_step(jax.random.PRNGKey(1))
    b, _ = _sr_step(jax.random.PRNGKey(1))
    c, _ = _sr_step(jax.random.PRNGKey(2))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (np.asarray(a) != np.asarray(c)).any()
