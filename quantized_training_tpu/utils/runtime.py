"""Process set-up shared by every entry point: the XLA flags, the compile
cache, the device check of measurement scripts, and the card's data-sheet
peaks."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

CHECKOUT = Path(__file__).resolve().parents[2]

# Dense data-sheet peaks per device_kind (NVIDIA H100 SXM5 data sheet:
# 989 TFLOP/s bf16, 1,979 TOP/s int8 and fp8, 3.35 TB/s HBM3). They assume
# the card's full 700 W power limit; report the limit beside any share.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,
        "int8_tops": 1979.0,
        "fp8_tflops": 1979.0,
        "hbm_tbps": 3.35,
    },
}


# XLA's Triton GEMM fusions gave run-to-run different results, NaN
# included, on an H100 (the weight-only int8 GEMMs of a llama2-1b prefill
# at 4 x 224 tokens); with them off, every GEMM is a cuBLAS(Lt) call and
# repeated runs agree bit for bit. A flag the user set in XLA_FLAGS wins.
XLA_FLAGS = ("--xla_gpu_enable_triton_gemm=false",)


def configure_xla() -> None:
    """Add :data:`XLA_FLAGS` to the ``XLA_FLAGS`` environment variable.
    XLA reads it when the first backend starts, so this runs on import of
    the package."""
    current = os.environ.get("XLA_FLAGS", "")
    missing = [f for f in XLA_FLAGS if f.split("=")[0] not in current]
    if missing:
        os.environ["XLA_FLAGS"] = " ".join([current, *missing]).strip()


def setup_compile_cache() -> str:
    """Persistent XLA compile cache: ``JAX_COMPILATION_CACHE_DIR`` when it
    is set (JAX reads it itself), else ``<checkout>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def require_gpu() -> dict:
    """Device info of this process's GPU; exits when JAX found none (a
    measurement never falls back to the CPU)."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX found {info['platform']} devices")
    return info


def peaks(kind: str | None = None) -> dict:
    """Data-sheet peaks of ``kind`` (default: this process's device)."""
    kind = kind or jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no peaks recorded for device {kind!r}")
    return PEAKS[kind]


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of the card(s) as nvidia-smi reports them,
    read in a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
