"""End-to-end slice tests: tiny Llama trains under every scheme; optimizer
lockstep vs fp32 oracle; data pipeline statefulness; checkpoint round-trip."""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantized_training_tpu import optim, quant
from quantized_training_tpu.data import BatchLoader, ShuffleDataset, SyntheticTokenDataset, TokenDataset
from quantized_training_tpu.models import llama
from quantized_training_tpu.train import init_train_state, make_train_step
from quantized_training_tpu.utils import LRSchedule, load_checkpoint, save_checkpoint

# hidden >= 128 so the default small-linear quantization filter still
# wraps every body linear
TINY = llama.LlamaConfig(
    vocab_size=256,
    hidden_size=128,
    intermediate_size=128,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    max_position_embeddings=64,
)


def _batch(key, bs=4, seq=32, vocab=256):
    toks = jax.random.randint(key, (bs, seq + 1), 0, vocab, dtype=jnp.int32)
    return toks[:, :-1], toks[:, 1:]


class TestLlamaModel:
    def test_forward_shapes_and_dtype(self):
        params = llama.init_params(jax.random.PRNGKey(0), TINY)
        tokens, _ = _batch(jax.random.PRNGKey(1))
        logits = llama.forward(params, tokens, TINY)
        assert logits.shape == (4, 32, 256)
        assert logits.dtype == jnp.bfloat16

    def test_causality(self):
        params = llama.init_params(jax.random.PRNGKey(0), TINY)
        tokens, _ = _batch(jax.random.PRNGKey(1))
        logits1 = llama.forward(params, tokens, TINY)
        # changing a future token must not affect past logits
        tokens2 = tokens.at[:, -1].set((tokens[:, -1] + 1) % 256)
        logits2 = llama.forward(params, tokens2, TINY)
        np.testing.assert_array_equal(
            np.asarray(logits1[:, :-1], np.float32),
            np.asarray(logits2[:, :-1], np.float32),
        )

    def test_config_from_hf_json(self):
        cfg = llama.LlamaConfig.from_hf_json(
            {
                "hidden_size": 1024,
                "intermediate_size": 4096,
                "num_hidden_layers": 24,
                "num_attention_heads": 16,
                "num_key_value_heads": 16,
                "rms_norm_eps": 1e-5,
                "unknown_field": 1,
            }
        )
        assert cfg.hidden_size == 1024 and cfg.num_hidden_layers == 24

    def test_bitnet_surgery_params(self):
        cfg = llama.LlamaConfig(**{**TINY.__dict__, "bitnet": True})
        params = llama.init_params(jax.random.PRNGKey(0), cfg)
        assert "o_norm" in params["layers"] and "down_norm" in params["layers"]
        tokens, _ = _batch(jax.random.PRNGKey(1))
        qp = quant.quantize_params(params, "bitnet")
        logits = llama.forward(qp, tokens, cfg)
        assert bool(jnp.all(jnp.isfinite(logits.astype(jnp.float32))))

    def test_ignore_index_loss(self):
        params = llama.init_params(jax.random.PRNGKey(0), TINY)
        tokens, labels = _batch(jax.random.PRNGKey(1))
        full = llama.loss_fn(params, tokens, labels, TINY)
        masked = llama.loss_fn(
            params, tokens, labels.at[:, :16].set(-100), TINY
        )
        assert np.isfinite(float(full)) and np.isfinite(float(masked))
        assert abs(float(full) - float(masked)) > 1e-6  # actually different


@pytest.mark.parametrize(
    "scheme,kwargs",
    [
        (None, {}),
        ("mixed_precision", {}),
        ("mixed_precision", {"stochastic_rounding": True}),
        ("int8_quantized_training", {"activation": "int8"}),
        ("int4_weight_only", {}),
        ("bitnet", {}),
    ],
)
def test_train_step_all_schemes(scheme, kwargs):
    params = llama.init_params(jax.random.PRNGKey(0), TINY)
    qparams = quant.quantize_params(params, scheme, **kwargs)
    opt = optim.adamw_bf16_sr()
    state = init_train_state(qparams, opt)
    step = make_train_step(TINY, opt, clip_grad_norm=1.0, donate=False)

    losses = []
    for i in range(5):
        tokens, labels = _batch(jax.random.PRNGKey(100 + i))
        state, metrics = step(state, tokens, labels, 1e-3, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
        assert np.isfinite(float(metrics["grad_norm"]))
    assert int(state.step) == 5


def test_grad_accumulation_close_to_large_batch():
    params = llama.init_params(jax.random.PRNGKey(0), TINY)
    opt = optim.adamw(weight_decay=0.0)
    step = make_train_step(TINY, opt, donate=False)

    tokens, labels = _batch(jax.random.PRNGKey(5), bs=8)
    s1 = init_train_state(params, opt)
    s1, m1 = step(s1, tokens, labels, 1e-3, jax.random.PRNGKey(0))

    micro_t = tokens.reshape(2, 4, -1)
    micro_l = labels.reshape(2, 4, -1)
    s2 = init_train_state(params, opt)
    s2, m2 = step(s2, micro_t, micro_l, 1e-3, jax.random.PRNGKey(0))

    # bf16 params mean small drift; losses should agree closely
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 0.05


class TestOptim:
    def test_adamw_bf16_sr_lockstep_fp32(self):
        """fp32 params: SR never engages -> must match fp32 AdamW math."""
        key = jax.random.PRNGKey(0)
        p = {"w": jax.random.normal(key, (32, 32), jnp.float32)}
        opt_sr = optim.adamw_bf16_sr()
        opt_ref = optim.adamw()
        s1, s2 = opt_sr.init(p), opt_ref.init(p)
        p1, p2 = p, p
        for i in range(10):
            g = {
                "w": jax.random.normal(jax.random.fold_in(key, i), (32, 32))
                * 0.1
            }
            p1, s1 = opt_sr.step(g, s1, p1, 1e-2, jax.random.PRNGKey(i))
            p2, s2 = opt_ref.step(g, s2, p2, 1e-2)
        # bf16 states vs fp32 states -> small drift allowed
        np.testing.assert_allclose(
            np.asarray(p1["w"]), np.asarray(p2["w"]), rtol=0, atol=2e-3
        )

    def test_adamw_bf16_states_are_bf16(self):
        p = {"w": jnp.zeros((8, 8), jnp.bfloat16)}
        opt = optim.adamw_bf16_sr()
        s = opt.init(p)
        assert s.exp_avg["w"].dtype == jnp.bfloat16
        assert s.exp_avg_sq["w"].dtype == jnp.bfloat16

    def test_schedule_free_train_eval_roundtrip(self):
        p = {"w": jax.random.normal(jax.random.PRNGKey(0), (16, 16))}
        opt = optim.schedule_free_adamw(warmup_steps=2)
        s = opt.init(p)
        for i in range(5):
            g = {"w": jax.random.normal(jax.random.PRNGKey(10 + i), (16, 16))}
            p, s = opt.step(g, s, p, 1e-2)
        pe = optim.eval_params(p, s)
        pt = optim.train_params(pe, s)
        np.testing.assert_allclose(
            np.asarray(pt["w"]), np.asarray(p["w"]), rtol=1e-4, atol=1e-5
        )

    def test_schedule_free_lr0_first_step_stays_finite(self):
        """An lr=0 first step (any warmup schedule's step 0) must not NaN
        the params: weight_sum==0 means ckp1=0, not 0/0 (the reference's
        schedule_free_adamw.py catches ZeroDivisionError for this)."""
        p = {"w": jax.random.normal(jax.random.PRNGKey(0), (16, 16))}
        opt = optim.schedule_free_adamw()
        s = opt.init(p)
        g = {"w": jax.random.normal(jax.random.PRNGKey(1), (16, 16))}
        p, s = opt.step(g, s, p, 0.0)
        assert np.isfinite(np.asarray(p["w"])).all()
        p, s = opt.step(g, s, p, 1e-2)  # and training proceeds normally
        assert np.isfinite(np.asarray(p["w"])).all()

    def test_schedule_free_decreases_loss(self):
        k = jax.random.PRNGKey(0)
        w_true = jax.random.normal(k, (16,))
        X = jax.random.normal(jax.random.fold_in(k, 1), (128, 16))
        y = X @ w_true
        p = {"w": jnp.zeros((16,))}
        opt = optim.schedule_free_adamw(warmup_steps=5)
        s = opt.init(p)

        def loss(p):
            return jnp.mean((X @ p["w"] - y) ** 2)

        l0 = float(loss(p))
        for _ in range(50):
            g = jax.grad(loss)(p)
            p, s = opt.step(g, s, p, 0.05)
        assert float(loss(optim.eval_params(p, s))) < l0 * 0.1

    def test_state8bit_roundtrip(self):
        x = jnp.abs(jax.random.normal(jax.random.PRNGKey(0), (4096,))) * 0.01
        st = optim.OptimState8bit.zeros((4096,), signed=False)
        st = st.requantize(x)
        deq = st.dequantize()
        rel = float(jnp.abs(deq - x).mean() / jnp.abs(x).mean())
        assert rel < 0.05, rel

    def test_get_optimizer_registry(self):
        assert optim.get_optimizer("adamw_bf16_sr") is not None
        with pytest.raises(ValueError):
            optim.get_optimizer("sgd_nope")


class TestData:
    def test_token_dataset_roundtrip_and_state(self, tmp_path):
        rng = np.random.default_rng(0)
        for i in range(2):
            (rng.integers(0, 1000, 999, dtype=np.uint16)).tofile(
                tmp_path / f"shard{i}.bin"
            )
        ds = TokenDataset(str(tmp_path), seq_len=32)
        it = iter(ds)
        first = [next(it) for _ in range(10)]
        state = ds.state_dict()

        ds2 = TokenDataset(str(tmp_path), seq_len=32)
        ds2.load_state_dict(state)
        resumed = [next(iter(ds2)) for _ in range(3)]
        cont = [next(it) for _ in range(3)]
        for (a, _), (b, _) in zip(resumed, cont):
            np.testing.assert_array_equal(a, b)
        # windows are shifted by one
        x, y = first[0]
        np.testing.assert_array_equal(x[1:], y[:-1])

    def test_eval_mode_is_finite_and_ordered(self, tmp_path):
        np.arange(66, dtype=np.uint16).tofile(tmp_path / "s.bin")
        ds = TokenDataset(str(tmp_path), seq_len=32, eval=True)
        samples = list(ds)
        assert len(samples) == 2
        np.testing.assert_array_equal(samples[0][0], np.arange(32))

    def test_shuffle_dataset_state(self):
        ds = SyntheticTokenDataset(seq_len=8, vocab_size=100, n_samples=None)
        sds = ShuffleDataset(ds, buffer_size=16, seed=7)
        it = iter(sds)
        _ = [next(it) for _ in range(20)]
        state = sds.state_dict()
        cont = [next(it)[0] for _ in range(5)]

        ds2 = SyntheticTokenDataset(seq_len=8, vocab_size=100, n_samples=None)
        sds2 = ShuffleDataset(ds2, buffer_size=16, seed=7)
        sds2.load_state_dict(state)
        resumed = [next(iter(sds2))[0] for _ in range(5)]
        for a, b in zip(cont, resumed):
            np.testing.assert_array_equal(a, b)

    def test_batch_loader(self):
        ds = SyntheticTokenDataset(seq_len=8, n_samples=10)
        dl = BatchLoader(ds, batch_size=4)
        batches = list(dl)
        assert len(batches) == 2  # ragged tail dropped
        assert batches[0][0].shape == (4, 8)


class TestLRSchedule:
    def test_warmup_hold_decay(self):
        sch = LRSchedule(1.0, 100, warmup=0.1, decay=0.2)
        assert sch.get_lr(0) == 0.0
        assert sch.get_lr(5) == 0.5
        assert sch.get_lr(50) == 1.0
        assert abs(sch.get_lr(90) - 0.5) < 1e-9
        assert sch.get_lr(100) == 0.0

    def test_cosine(self):
        sch = LRSchedule(1.0, 100, decay=1.0, decay_type="cosine")
        assert abs(sch.get_lr(50) - 0.5) < 1e-9


class TestCheckpoint:
    def test_roundtrip_with_quant_wrappers(self, tmp_path):
        params = llama.init_params(jax.random.PRNGKey(0), TINY)
        qparams = quant.quantize_params(params, "int8_quantized_training")
        opt = optim.adamw_bf16_sr()
        state = init_train_state(qparams, opt)
        save_checkpoint(
            tmp_path / "ckpt.pkl",
            {"params": state.params, "opt": state.opt_state, "meta": {"step": 3}},
        )
        loaded = load_checkpoint(tmp_path / "ckpt.pkl")
        assert loaded["meta"]["step"] == 3
        w0 = state.params["layers"]["q"]["w"]
        w1 = loaded["params"]["layers"]["q"]["w"]
        assert isinstance(w1, quant.Int8Weight)
        np.testing.assert_array_equal(np.asarray(w0.int_data), w1.int_data)


class TestFusedCrossEntropy:
    def test_fused_loss_matches_explicit_logits(self):
        """llama.loss_fn (chunk-fused head+CE) == the explicit-logits
        log_softmax path, for loss AND grads."""
        cfg = TINY
        params = llama.init_params(jax.random.PRNGKey(0), cfg)
        tokens = jax.random.randint(
            jax.random.PRNGKey(1), (2, 32), 0, cfg.vocab_size, jnp.int32
        )
        labels = jnp.roll(tokens, -1, -1).at[:, -1].set(-100)

        def explicit(params):
            logits = llama.forward(params, tokens, cfg).astype(jnp.float32)
            V = logits.shape[-1]
            lg = logits.reshape(-1, V)
            lb = labels.reshape(-1)
            valid = lb != -100
            logp = jax.nn.log_softmax(lg, axis=-1)
            nll = -jnp.take_along_axis(
                logp, jnp.where(valid, lb, 0)[:, None], axis=-1
            )[:, 0]
            return jnp.where(valid, nll, 0.0).sum() / jnp.maximum(valid.sum(), 1)

        def fused(params):
            return llama.loss_fn(params, tokens, labels, cfg)

        l_ref, g_ref = jax.value_and_grad(explicit)(params)
        l_fused, g_fused = jax.value_and_grad(fused)(params)
        assert abs(float(l_ref) - float(l_fused)) < 2e-3
        for a, b in zip(jax.tree.leaves(g_ref), jax.tree.leaves(g_fused)):
            af, bf = np.asarray(a, np.float32), np.asarray(b, np.float32)
            scale = max(np.abs(af).max(), 1e-6)
            assert np.abs(af - bf).max() / scale < 0.02
