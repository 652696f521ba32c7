"""Test-session configuration.

The suite runs on the CPU backend with 8 virtual devices, set BEFORE jax
is imported anywhere, so multi-device sharding logic (mesh / pjit /
shard_map / collectives) is exercised without GPUs. Pallas kernels run in
interpret mode here; their compiled form runs on the card in
`chip_smoke.py`.

Tests that need a real GPU take the `gpu` fixture and carry the `chip`
marker: the fixture decides at run time (never at import or collection
time) and skips when the default backend is not a GPU.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

from densepoints.utils.cache import enable_compilation_cache

# Persistent compilation cache: recompiles dominate the suite's wall time.
# XLA:CPU persists its kernels only with the xla-caches knob on.
if enable_compilation_cache() is not None:
    jax.config.update("jax_persistent_cache_enable_xla_caches", "all")

import numpy as np
import pytest


@pytest.fixture()
def rng():
    # Function-scoped: every test gets the same fresh seeded stream, so
    # outcomes never depend on execution order.
    return np.random.default_rng(0)


@pytest.fixture()
def gpu():
    """The first GPU device; skips the test on any other backend."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {device.platform})")
    return device


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-process / long-running integration tests"
    )
    config.addinivalue_line(
        "markers",
        "chip: needs a real GPU (skips elsewhere; run on the card by "
        "`python chip_smoke.py`)",
    )
