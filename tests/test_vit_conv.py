"""ViT model + int8 conv2d tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantized_training_tpu import optim, quant
from quantized_training_tpu.models import vit
from quantized_training_tpu.ops import conv as conv_ops

# hidden >= 128 so the default small-linear quantization filter (which
# skips any linear with a dim < 128) still wraps the body linears
TINY_VIT = vit.ViTConfig(
    image_size=32, patch_size=8, hidden_size=128, num_layers=2, num_heads=2,
    num_classes=10,
)


def _images(key, bs=4, size=32):
    return jax.random.normal(key, (bs, size, size, 3), jnp.float32)


class TestViT:
    def test_forward_shape(self):
        params = vit.init_params(jax.random.PRNGKey(0), TINY_VIT)
        logits = vit.forward(params, _images(jax.random.PRNGKey(1)), TINY_VIT)
        assert logits.shape == (4, 10)

    def test_patchify_roundtrip_content(self):
        imgs = jnp.arange(2 * 32 * 32 * 3, dtype=jnp.float32).reshape(2, 32, 32, 3)
        p = vit.patchify(imgs, 8)
        assert p.shape == (2, 16, 192)
        # first patch contains the top-left 8x8 block
        np.testing.assert_array_equal(
            np.asarray(p[0, 0].reshape(8, 8, 3)), np.asarray(imgs[0, :8, :8, :])
        )

    @pytest.mark.parametrize("scheme", ["mixed_precision", "int8_quantized_training"])
    def test_quantized_training_step(self, scheme):
        params = vit.init_params(jax.random.PRNGKey(0), TINY_VIT)
        qparams = quant.quantize_params(params, scheme)
        # every linear got wrapped, including qkv/fc inside scan stacks
        assert quant.is_quant_weight(qparams["layers"]["qkv"]["w"])
        assert quant.is_quant_weight(qparams["patch_embed"]["w"])
        opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
        opt_state = opt.init(quant.virtual_params(qparams))

        imgs = _images(jax.random.PRNGKey(1))
        labels = jnp.array([0, 1, 2, 3])

        @jax.jit
        def step(qparams, opt_state):
            v = quant.virtual_params(qparams)

            def loss(v):
                merged = quant.merge_masters(v, qparams)
                return vit.loss_fn(merged, imgs, labels, TINY_VIT)

            l, g = jax.value_and_grad(loss)(v)
            v2, opt_state2 = opt.step(g, opt_state, v, 1e-3)
            return quant.commit_params(v2, qparams, jax.random.PRNGKey(0)), opt_state2, l

        losses = []
        for _ in range(8):
            qparams, opt_state, l = step(qparams, opt_state)
            losses.append(float(l))
        assert losses[-1] < losses[0], losses  # memorizes 4 images


class TestConv2d:
    def test_int8_conv_exact_vs_numpy(self):
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        x = jax.random.randint(k1, (2, 8, 8, 4), -128, 128, dtype=jnp.int8)
        w = jax.random.randint(k2, (3, 3, 4, 8), -128, 128, dtype=jnp.int8)
        out = conv_ops.int8_conv2d(x, w, stride=1, padding=1)
        assert out.dtype == jnp.int32 and out.shape == (2, 8, 8, 8)

        xf = np.asarray(x, np.int64)
        wf = np.asarray(w, np.int64)
        xp = np.pad(xf, ((0, 0), (1, 1), (1, 1), (0, 0)))
        ref = np.zeros((2, 8, 8, 8), np.int64)
        for i in range(8):
            for j in range(8):
                patch = xp[:, i : i + 3, j : j + 3, :]
                ref[:, i, j, :] = np.einsum("bhwc,hwco->bo", patch, wf)
        np.testing.assert_array_equal(np.asarray(out, np.int64), ref)

    @pytest.mark.parametrize("kernel,cin", [(3, 128), (3, 256), (1, 2048)])
    def test_int8_conv_exact_past_fp32_integer_range(self, kernel, cin):
        """kh*kw*Cin above 1024 with large same-sign products: one fp32 sum
        would pass 2^24 and round; the channel groups keep it exact."""
        k1, k2 = jax.random.split(jax.random.PRNGKey(kernel * cin))
        x = jax.random.randint(k1, (1, 4, 4, cin), 120, 128, jnp.int8)
        w = jax.random.randint(k2, (kernel, kernel, cin, 2), 120, 128, jnp.int8)
        pad = kernel // 2
        out = conv_ops.int8_conv2d(x, w, padding=pad)
        xp = np.pad(np.asarray(x, np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        wf = np.asarray(w, np.int64)
        ref = np.zeros((1, 4, 4, 2), np.int64)
        for i in range(4):
            for j in range(4):
                ref[:, i, j] = np.einsum("bhwc,hwco->bo", xp[:, i : i + kernel, j : j + kernel], wf)
        assert np.abs(ref).max() > 2**24
        np.testing.assert_array_equal(np.asarray(out, np.int64), ref)

    def test_scaled_int8_conv(self):
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
        x = jax.random.randint(k1, (2, 8, 8, 4), -128, 128, dtype=jnp.int8)
        w = jax.random.randint(k2, (3, 3, 4, 8), -128, 128, dtype=jnp.int8)
        cs = jax.random.uniform(k3, (8,)) * 0.01
        out = conv_ops.scaled_int8_conv2d(x, w, cs, padding=1, out_dtype=jnp.float32)
        ref = conv_ops.int8_conv2d(x, w, padding=1).astype(jnp.float32) * cs.reshape(1, 1, 1, -1)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5)

    def test_strided(self):
        x = jax.random.randint(jax.random.PRNGKey(2), (1, 16, 16, 3), -128, 128, dtype=jnp.int8)
        w = jax.random.randint(jax.random.PRNGKey(3), (2, 2, 3, 5), -128, 128, dtype=jnp.int8)
        out = conv_ops.int8_conv2d(x, w, stride=2)
        assert out.shape == (1, 8, 8, 5)
