"""Test config: the CPU with a virtual 8-device mesh unless the caller
names a platform.

XLA's host platform is split into 8 virtual devices so sharding/collective
tests exercise real SPMD partitioning without a cluster. Tests marked
``gpu`` need the card: run them there with ``JAX_PLATFORMS=cuda python -m
pytest -m gpu tests/``; elsewhere the ``gpu`` fixture skips them.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if (
    os.environ["JAX_PLATFORMS"] == "cpu"
    and "xla_force_host_platform_device_count" not in flags
):
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The GPU device, decided when the test runs (never at import)."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {d.platform}")
    return d
