"""Process set-up helpers: the compile cache and the peaks table."""

import os

import jax
import pytest

from quantized_training_tpu.utils import runtime


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_environment_sets_nothing(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert runtime.setup_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.setup_compile_cache()
    assert path == str(runtime.CHECKOUT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert (runtime.CHECKOUT / "llm_pretrain.py").exists()


def test_peaks_keyed_by_device_kind():
    assert runtime.peaks("NVIDIA H100 80GB HBM3")["int8_tops"] == 1979.0
    with pytest.raises(KeyError, match="no peaks"):
        runtime.peaks("some other card")


@pytest.mark.parametrize("before,after", [
    (None, "--xla_gpu_enable_triton_gemm=false"),
    ("--xla_force_host_platform_device_count=8",
     "--xla_force_host_platform_device_count=8 --xla_gpu_enable_triton_gemm=false"),
    ("--xla_gpu_enable_triton_gemm=true", "--xla_gpu_enable_triton_gemm=true"),
])
def test_configure_xla_adds_flags_the_user_left_unset(monkeypatch, before, after):
    if before is None:
        monkeypatch.delenv("XLA_FLAGS", raising=False)
    else:
        monkeypatch.setenv("XLA_FLAGS", before)
    runtime.configure_xla()
    assert os.environ["XLA_FLAGS"] == after
    runtime.configure_xla()  # idempotent
    assert os.environ["XLA_FLAGS"] == after
