"""Causal GQA attention: the XLA implementation against the fp32
reference, the prefill path of inference against the cache einsum, and
the one platform decision that picks cuDNN on the GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantized_training_tpu.models import llama, llama_infer

HEADS = [(32, 4), (8, 8), (8, 2)]
SEQS = [128, 256]


def _qkv(h, kv, s, dtype=jnp.bfloat16, b=1, hd=64):
    ks = jax.random.split(jax.random.PRNGKey(h * 1000 + kv * 10 + s), 3)
    return (jax.random.normal(ks[0], (b, s, h, hd), dtype),
            jax.random.normal(ks[1], (b, s, kv, hd), dtype),
            jax.random.normal(ks[2], (b, s, kv, hd), dtype))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("h,kv", HEADS)
def test_xla_forward_matches_reference(h, kv, s):
    """bf16 in, fp32 scores and softmax, P rounded to bf16 before PV."""
    q, k, v = _qkv(h, kv, s)
    out = llama.attention(q, k, v, impl="xla")
    ref = llama.attention_ref(q, k, v)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert _rel(out, ref) < 1e-2


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("h,kv", HEADS)
def test_xla_grads_match_reference(h, kv, s):
    q, k, v = _qkv(h, kv, s)
    r = jax.random.normal(jax.random.PRNGKey(9), q.shape)

    def loss(f, *t):
        return jnp.sum(f(*t).astype(jnp.float32) * r)

    grads = jax.grad(lambda *t: loss(lambda *u: llama.attention(*u, impl="xla"), *t),
                     argnums=(0, 1, 2))(q, k, v)
    f32 = [t.astype(jnp.float32) for t in (q, k, v)]
    ref = jax.grad(lambda *t: loss(llama.attention_ref, *t), argnums=(0, 1, 2))(*f32)
    for g, rg, t in zip(grads, ref, (q, k, v)):
        assert g.shape == t.shape
        assert _rel(g, rg) < 2e-2


@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_prefill_attention_matches_cache_einsum(heads):
    """Prefill at pos 0 through llama.attention == attention over the
    freshly written int8 cache (the decode path's einsum)."""
    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                            num_hidden_layers=2, num_attention_heads=heads[0],
                            num_key_value_heads=heads[1])
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0, 256)
    cache = llama_infer.KVCache.zeros(cfg, 2, 32)
    flash, c1 = llama_infer.forward_with_cache(params, tokens, cache, 0, cfg, flash_prefill=True)
    einsum, c2 = llama_infer.forward_with_cache(params, tokens, cache, 0, cfg, flash_prefill=False)
    assert _rel(flash.astype(jnp.float32), einsum.astype(jnp.float32)) < 2e-2
    np.testing.assert_array_equal(np.asarray(c1.k), np.asarray(c2.k))


@pytest.mark.parametrize("platform,impl", [("gpu", "cudnn"), ("cpu", "xla"),
                                           ("rocm", None), ("metal", None)])
def test_implementation_by_platform(monkeypatch, platform, impl):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if impl is None:
        with pytest.raises(RuntimeError, match="no attention implementation"):
            llama.attention_implementation()
    else:
        assert llama.attention_implementation() == impl


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_sharded_step_takes_xla_attention(monkeypatch, platform):
    """A step partitioned over several devices takes the platform's kernel
    (cuDNN on the GPU, XLA's composite on the CPU) per shard: under the
    mesh, attention sees its local batch rows."""
    from quantized_training_tpu import optim
    from quantized_training_tpu.parallel import make_mesh
    from quantized_training_tpu.train import init_train_state, make_train_step

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    seen = []

    def fake(q, k, v, is_causal, implementation):
        seen.append((implementation, q.shape[0]))
        return q

    monkeypatch.setattr(jax.nn, "dot_product_attention", fake)
    cfg = llama.LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=64,
                            num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    opt = optim.adamw()
    tok = jnp.zeros((4, 8), jnp.int32)
    impl = {"gpu": "cudnn", "cpu": "xla"}[platform]
    for mesh, rows in ((None, 4), (make_mesh({"fsdp": 4}), 1), (make_mesh({"data": 2, "fsdp": 2}), 1)):
        seen.clear()
        step = make_train_step(cfg, opt, mesh=mesh, jit_compile=False)
        jax.eval_shape(step, init_train_state(params, opt), tok, tok, 1e-3,
                       jax.random.PRNGKey(0))
        assert seen and set(seen) == {(impl, rows)}


@pytest.mark.parametrize("axes,spec", [
    ({"fsdp": 4}, ("fsdp", None, None, None)),
    ({"data": 2, "fsdp": 2}, (("data", "fsdp"), None, None, None)),
    ({"model": 4}, (None, None, "model", None)),
    ({"data": 2, "model": 2}, ("data", None, "model", None)),
])
def test_attention_spec_per_mesh(axes, spec):
    """Batch rows split over 'data' x 'fsdp', KV-head groups over 'model'."""
    from quantized_training_tpu.parallel import make_mesh

    assert tuple(llama._attention_spec(make_mesh(axes), 4, 4)) == spec


def test_attention_spec_keeps_undivided_dims_whole():
    from quantized_training_tpu.parallel import make_mesh

    assert tuple(llama._attention_spec(make_mesh({"fsdp": 4}), 2, 4)) == (None,) * 4
    assert tuple(llama._attention_spec(make_mesh({"model": 4}), 4, 2)) == (None,) * 4


@pytest.mark.parametrize("axes", [{"fsdp": 4}, {"data": 2, "fsdp": 2}, {"model": 4}])
def test_attention_under_mesh_matches_unsharded(axes):
    """Per-shard attention under a mesh equals the unsharded op, values
    and gradients."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from quantized_training_tpu.parallel import make_mesh

    q, k, v = _qkv(8, 4, 32, jnp.float32, b=4, hd=16)
    loss = lambda *t: jnp.sum(llama.attention(*t) ** 2)
    ref = jax.value_and_grad(loss, argnums=(0, 1, 2))(q, k, v)
    mesh = make_mesh(axes)

    def under_mesh(*t):
        with jax.sharding.use_abstract_mesh(mesh.abstract_mesh):
            return jax.value_and_grad(loss, argnums=(0, 1, 2))(*t)

    args = [jax.device_put(t, NamedSharding(mesh, P())) for t in (q, k, v)]
    got = jax.jit(under_mesh)(*args)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    for g, r in zip(got[1], ref[1]):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)
