"""Scheme tests: quantized linears vs dequantized-autodiff references.

Covers the SURVEY.md §4 implication list: (b) round-trip, (c) gradient
checks of the custom-VJP linears vs autodiff on dequantized weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantized_training_tpu import quant
from quantized_training_tpu.quant import bitnet as bitnet_mod
from quantized_training_tpu.quant import core


def _loss(out):
    return (out.astype(jnp.float32) ** 2).sum()


class TestMixedPrecision:
    def _setup(self, **cfg_kwargs):
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        x = jax.random.normal(k1, (16, 64), jnp.float32)
        w = jax.random.normal(k2, (32, 64), jnp.float32) * 0.1
        cfg = quant.MixedPrecisionConfig(**cfg_kwargs)
        return x, w, quant.MixedPrecisionWeight(w, cfg)

    def test_all_bf16_exact(self):
        x, w, qw = self._setup(output=False, grad_input=False, grad_weight=False)
        out = quant.qlinear(x, qw)
        np.testing.assert_allclose(np.asarray(out), np.asarray(x @ w.T), rtol=1e-6)
        gx, gw = jax.grad(lambda x, qw: _loss(quant.qlinear(x, qw)), argnums=(0, 1))(x, qw)
        gx_ref, gw_ref = jax.grad(lambda x, w: _loss(x @ w.T), argnums=(0, 1))(x, w)
        np.testing.assert_allclose(np.asarray(gx), np.asarray(gx_ref), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(gw.data), np.asarray(gw_ref), rtol=1e-5)

    @pytest.mark.parametrize("dtype", ["int8", "int4"])
    def test_quantized_close_to_fp(self, dtype):
        x, w, qw = self._setup(dtype=dtype)
        out = quant.qlinear(x, qw)
        ref = x @ w.T
        rel = jnp.abs(out.astype(jnp.float32) - ref).mean() / jnp.abs(ref).mean()
        assert rel < (0.02 if dtype == "int8" else 0.15), rel

        gx, gw = jax.grad(lambda x, qw: _loss(quant.qlinear(x, qw)), argnums=(0, 1))(x, qw)
        gx_ref, gw_ref = jax.grad(lambda x, w: _loss(x @ w.T), argnums=(0, 1))(x, w)
        for g, gr in [(gx, gx_ref), (gw.data, gw_ref)]:
            rel = jnp.abs(g - gr).mean() / jnp.abs(gr).mean()
            assert rel < (0.05 if dtype == "int8" else 0.3), rel

    def test_sr_runs_and_is_keyed(self):
        x, w, qw = self._setup(stochastic_rounding=True)
        o1 = quant.qlinear(x, qw, key=jax.random.PRNGKey(1))
        o2 = quant.qlinear(x, qw, key=jax.random.PRNGKey(2))
        o1b = quant.qlinear(x, qw, key=jax.random.PRNGKey(1))
        assert not np.array_equal(np.asarray(o1), np.asarray(o2))
        np.testing.assert_array_equal(np.asarray(o1), np.asarray(o1b))

    def test_bias(self):
        x, w, qw = self._setup(output=False, grad_input=False, grad_weight=False)
        b = jnp.arange(32, dtype=jnp.float32)
        out = quant.qlinear(x, qw, b)
        np.testing.assert_allclose(np.asarray(out), np.asarray(x @ w.T + b), rtol=1e-6)

    def test_batch_dims(self):
        x, w, qw = self._setup()
        x3 = x.reshape(4, 4, 64)
        out = quant.qlinear(x3, qw)
        assert out.shape == (4, 4, 32)


class TestPreQuantizedWeights:
    """Per-step weight pre-quantization (quant/api.py::prequantize_step):
    the same quantize of the same weight, hoisted out of the layer loop —
    output and grads must be BIT-IDENTICAL to the dynamic path (non-SR).

    Default-off (see prequantize_step's docstring); the path stays
    tested here."""

    @pytest.mark.parametrize(
        "toggles",
        [(True, True, True), (True, True, False), (True, False, True),
         (False, True, True), (True, False, False)],
    )
    @pytest.mark.parametrize("mode", ["both", "row", "col"])
    def test_bitexact_vs_dynamic(self, toggles, mode):
        from quantized_training_tpu.quant import mixed_precision as mp

        cfg = quant.MixedPrecisionConfig(
            output=toggles[0], grad_input=toggles[1], grad_weight=toggles[2]
        )
        x = jax.random.normal(jax.random.PRNGKey(1), (64, 128), jnp.float32)
        wd = jax.random.normal(jax.random.PRNGKey(2), (256, 128)) * 0.05

        def loss_dyn(x, wd):
            return _loss(mp.linear(x, mp.MixedPrecisionWeight(wd, cfg)))

        def loss_pq(x, wd):
            w = mp.prequantize_weight(
                mp.MixedPrecisionWeight(wd, cfg), mode=mode
            )
            return _loss(mp.linear(x, w))

        np.testing.assert_array_equal(
            np.asarray(loss_dyn(x, wd)), np.asarray(loss_pq(x, wd))
        )
        g1 = jax.grad(loss_dyn, argnums=(0, 1))(x, wd)
        g2 = jax.grad(loss_pq, argnums=(0, 1))(x, wd)
        for a, b in zip(g1, g2):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_shared_input_bitexact(self):
        from quantized_training_tpu.quant import mixed_precision as mp

        cfg = quant.MixedPrecisionConfig()
        x = jax.random.normal(jax.random.PRNGKey(1), (64, 128), jnp.float32)
        ws = [
            jax.random.normal(jax.random.PRNGKey(2 + i), (256, 128)) * 0.05
            for i in range(3)
        ]
        dyn = [mp.MixedPrecisionWeight(w, cfg) for w in ws]
        pq = [mp.prequantize_weight(w) for w in dyn]
        for od, op in zip(mp.linear_shared(x, dyn), mp.linear_shared(x, pq)):
            np.testing.assert_array_equal(np.asarray(od), np.asarray(op))

    def test_backbone_env_toggle(self, monkeypatch):
        """QT_PREQUANT routes the model's scan through the pre-quantized
        linears; loss stays within bf16 fusion noise of the dynamic path
        (scan fusion boundaries shift, so bit-exactness is only per-op)."""
        from quantized_training_tpu.models import llama

        lcfg = llama.LlamaConfig(
            vocab_size=256, hidden_size=128, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, max_position_embeddings=64, remat=True,
        )
        params = llama.init_params(jax.random.PRNGKey(0), lcfg)
        qp = quant.quantize_params(params, "mixed_precision")
        toks = jax.random.randint(
            jax.random.PRNGKey(5), (2, 33), 0, 256, jnp.int32
        )
        losses = {}
        for mode in ["0", "both"]:
            monkeypatch.setenv("QT_PREQUANT", mode)
            losses[mode] = float(
                llama.loss_fn(qp, toks[:, :-1], toks[:, 1:], lcfg)
            )
        assert abs(losses["0"] - losses["both"]) < 1e-3, losses


class TestInt8QT:
    def _setup(self, activation="none"):
        k1, k2 = jax.random.split(jax.random.PRNGKey(1))
        x = jax.random.normal(k1, (16, 64), jnp.float32)
        w = jax.random.normal(k2, (32, 64), jnp.float32) * 0.1
        qw = quant.Int8Weight.from_float(w, quant.Int8QTConfig(activation))
        return x, qw

    def test_weight_only_forward(self):
        x, qw = self._setup("none")
        out = quant.qlinear(x, qw)
        ref = x @ qw.dequantize().T
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4, atol=1e-4)

    def test_dynamic_act_forward(self):
        x, qw = self._setup("int8")
        out = quant.qlinear(x, qw)
        ref = x @ qw.dequantize().T
        rel = jnp.abs(out - ref).mean() / jnp.abs(ref).mean()
        assert rel < 0.02, rel

    def test_grads_route_to_master(self):
        x, qw = self._setup("int8")
        master = qw.dequantize()

        def loss(x, master):
            import dataclasses

            qw2 = dataclasses.replace(qw, master=master)
            return _loss(quant.qlinear(x, qw2))

        gx, gm = jax.grad(loss, argnums=(0, 1))(x, master)
        # reference bwd: grad_input = (g*scale.T) @ int_data; grad_w = g.T @ x
        out = quant.qlinear(x, quant.Int8Weight(qw.int_data, qw.scale, master, qw.config))
        g = 2 * out
        gx_ref = (g * qw.scale.reshape(1, -1)) @ qw.int_data.astype(jnp.float32)
        gm_ref = g.T @ x
        np.testing.assert_allclose(np.asarray(gx), np.asarray(gx_ref), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(gm), np.asarray(gm_ref), rtol=1e-4, atol=1e-4)


class TestInt4WO:
    def test_forward_and_grads(self):
        k1, k2 = jax.random.split(jax.random.PRNGKey(2))
        x = jax.random.normal(k1, (8, 64), jnp.float32)
        w = jax.random.normal(k2, (32, 64), jnp.float32)
        qw = quant.Int4Weight.from_float(w, group_size=32)
        assert qw.shape == (32, 64)
        out = quant.qlinear(x, qw)
        deq = qw.dequantize()
        np.testing.assert_allclose(np.asarray(out), np.asarray(x @ deq.T), rtol=1e-5, atol=1e-5)

        import dataclasses

        def loss(x, master):
            return _loss(quant.qlinear(x, dataclasses.replace(qw, master=master)))

        gx, gm = jax.grad(loss, argnums=(0, 1))(x, deq)
        g = 2 * (x @ deq.T)
        np.testing.assert_allclose(np.asarray(gx), np.asarray(g @ deq), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(gm), np.asarray(g.T @ x), rtol=1e-4, atol=1e-4)

    def test_stacked_layer_dims(self):
        w = jax.random.normal(jax.random.PRNGKey(3), (4, 16, 64))
        qw = quant.Int4Weight.from_float(w, group_size=32)
        assert qw.packed.shape == (4, 32, 16)
        deq = qw.dequantize()
        assert deq.shape == (4, 16, 64)
        err = jnp.abs(deq - w).max()
        assert err < float(qw.scale.max()) / 2 + 1e-6


class TestBitNet:
    def test_forward_matches_manual(self):
        k1, k2 = jax.random.split(jax.random.PRNGKey(4))
        x = jax.random.normal(k1, (8, 64), jnp.float32)
        w = jax.random.normal(k2, (32, 64), jnp.float32) * 0.05
        out = quant.qlinear(x, quant.BitNetWeight(w))

        x_i8, row_scale = core.quantize_int8(x, eps=1e-5)
        ts = core.get_bitnet_scale(w)
        w_i8 = core.quantize_bitnet_weight(w, ts)
        ref = (
            (x_i8.astype(jnp.float32) @ w_i8.astype(jnp.float32).T)
            * row_scale
            * ts
        )
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-3, atol=1e-3)

    def test_grads_match_reference_formulas(self):
        k1, k2 = jax.random.split(jax.random.PRNGKey(5))
        x = jax.random.normal(k1, (8, 64), jnp.float32)
        w = jax.random.normal(k2, (32, 64), jnp.float32) * 0.05

        def loss(x, bw):
            return _loss(quant.qlinear(x, bw))

        gx, gw = jax.grad(loss, argnums=(0, 1))(x, quant.BitNetWeight(w))

        x_i8, row_scale = core.quantize_int8(x, eps=1e-5)
        ts = core.get_bitnet_scale(w)
        w_i8 = core.quantize_bitnet_weight(w, ts)
        out = (x_i8.astype(jnp.float32) @ w_i8.astype(jnp.float32).T) * row_scale * ts
        g = 2 * out
        gx_ref = (g @ w_i8.astype(jnp.float32)) * ts
        gw_ref = g.T @ (x_i8.astype(jnp.float32) * row_scale)
        np.testing.assert_allclose(np.asarray(gx), np.asarray(gx_ref), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(np.asarray(gw.data), np.asarray(gw_ref), rtol=1e-3, atol=1e-3)

    def test_packed_weight_roundtrip(self):
        w = jax.random.normal(jax.random.PRNGKey(6), (16, 64)) * 0.05
        pw = bitnet_mod.BitNetPackedWeight.from_weight(w)
        assert pw.packed.shape == (16, 16)
        ts = core.get_bitnet_scale(w)
        ref = core.quantize_bitnet_weight(w, ts).astype(jnp.float32) * ts.astype(jnp.float32)
        np.testing.assert_allclose(
            np.asarray(pw.dequantize(), np.float32), np.asarray(ref), rtol=1e-2
        )

    def test_packed_linear_matches_unpacked(self):
        k1, k2 = jax.random.split(jax.random.PRNGKey(7))
        x = jax.random.normal(k1, (8, 64), jnp.float32)
        w = jax.random.normal(k2, (32, 64), jnp.float32) * 0.05
        out_train = quant.qlinear(x, quant.BitNetWeight(w))
        out_packed = quant.qlinear(x, bitnet_mod.BitNetPackedWeight.from_weight(w))
        np.testing.assert_allclose(
            np.asarray(out_train), np.asarray(out_packed), rtol=1e-3, atol=1e-3
        )


class TestParamsAPI:
    def _params(self):
        # linear dims >= 128: the default filter skips small linears
        k = jax.random.PRNGKey(8)
        return {
            "embed": {"embedding": jax.random.normal(k, (100, 128))},
            "layers": {
                "q": {"w": jax.random.normal(k, (2, 128, 128)) * 0.1},
                "norm": {"g": jnp.ones((2, 128))},
            },
        }

    @pytest.mark.parametrize(
        "scheme,wrapper",
        [
            ("mixed_precision", quant.MixedPrecisionWeight),
            ("int8_quantized_training", quant.Int8Weight),
            ("int4_weight_only", quant.Int4Weight),
            ("bitnet", quant.BitNetWeight),
        ],
    )
    def test_quantize_params_wraps_only_linear_w(self, scheme, wrapper):
        qp = quant.quantize_params(self._params(), scheme)
        assert isinstance(qp["layers"]["q"]["w"], wrapper)
        assert not quant.is_quant_weight(qp["embed"]["embedding"])
        assert not quant.is_quant_weight(qp["layers"]["norm"]["g"])

    def test_none_scheme_noop(self):
        p = self._params()
        assert quant.quantize_params(p, None) is p

    def test_master_cycle_int8(self):
        qp = quant.quantize_params(self._params(), "int8_quantized_training")
        vp = quant.virtual_params(qp)
        # masters are dequantized floats
        assert vp["layers"]["q"]["w"].dtype == jnp.float32
        merged = quant.merge_masters(vp, qp)
        assert merged["layers"]["q"]["w"].master is not None
        # commit re-quantizes with SR; repeated commits stay near the value
        new_qp = quant.commit_params(vp, qp, jax.random.PRNGKey(0))
        deq_err = jnp.abs(
            quant.virtual_params(new_qp)["layers"]["q"]["w"]
            - vp["layers"]["q"]["w"]
        ).max()
        assert deq_err < float(qp["layers"]["q"]["w"].scale.max()) + 1e-6

    def test_master_cycle_preserves_plain_leaves(self):
        qp = quant.quantize_params(self._params(), "mixed_precision")
        vp = quant.virtual_params(qp)
        new_qp = quant.commit_params(vp, qp, jax.random.PRNGKey(0))
        assert isinstance(new_qp["layers"]["q"]["w"], quant.MixedPrecisionWeight)
        np.testing.assert_array_equal(
            np.asarray(new_qp["embed"]["embedding"]),
            np.asarray(qp["embed"]["embedding"]),
        )


class TestSharedInputLinear:
    def test_linear_shared_matches_independent(self):
        """qlinear_multi (one shared-input quantize) == independent
        qlinear calls bit-exactly in the deterministic all-int8 config,
        for outputs AND grads."""
        cfg = quant.MixedPrecisionConfig(
            output=True, grad_input=True, grad_weight=True
        )
        kx, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 4)
        x = jax.random.normal(kx, (64, 32), jnp.bfloat16)
        ws = [
            quant.MixedPrecisionWeight(
                jax.random.normal(k, (o, 32), jnp.bfloat16) * 0.2, cfg
            )
            for k, o in ((k1, 48), (k2, 16), (k3, 16))
        ]

        def loss_shared(x, datas):
            wl = [quant.MixedPrecisionWeight(d, cfg) for d in datas]
            outs = quant.qlinear_multi(x, wl)
            return sum((o.astype(jnp.float32) ** 2).sum() for o in outs)

        def loss_indep(x, datas):
            wl = [quant.MixedPrecisionWeight(d, cfg) for d in datas]
            outs = [quant.qlinear(x, w) for w in wl]
            return sum((o.astype(jnp.float32) ** 2).sum() for o in outs)

        datas = [w.data for w in ws]
        l1, g1 = jax.value_and_grad(loss_shared, argnums=(0, 1))(x, datas)
        l2, g2 = jax.value_and_grad(loss_indep, argnums=(0, 1))(x, datas)
        assert float(l1) == float(l2)
        # weight grads are bit-identical; the x cotangent is the SUM of the
        # three per-head grad_inputs — bf16 summation order differs between
        # the fused bwd (sequential) and autodiff's cotangent accumulation,
        # so allow a couple of ulps there
        for a, b in zip(jax.tree.leaves(g1[1]), jax.tree.leaves(g2[1])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_allclose(
            np.asarray(g1[0], np.float32), np.asarray(g2[0], np.float32),
            rtol=0.05, atol=0.05,
        )

    def test_fallback_other_schemes(self):
        x = jax.random.normal(jax.random.PRNGKey(1), (16, 32), jnp.bfloat16)
        w1 = quant.Int8Weight.from_float(
            jax.random.normal(jax.random.PRNGKey(2), (8, 32), jnp.bfloat16)
        )
        w2 = quant.Int8Weight.from_float(
            jax.random.normal(jax.random.PRNGKey(3), (8, 32), jnp.bfloat16)
        )
        outs = quant.qlinear_multi(x, [w1, w2])
        ref = [quant.qlinear(x, w1), quant.qlinear(x, w2)]
        for o, r in zip(outs, ref):
            np.testing.assert_array_equal(np.asarray(o), np.asarray(r))
