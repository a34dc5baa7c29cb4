"""Test harness: force an 8-virtual-device CPU platform.

Multi-device sharding paths are validated on a virtual CPU mesh
(xla_force_host_platform_device_count=8). Tests that need a GPU carry the
`gpu` marker and skip on the CPU (see the `gpu_devices` fixture); on the
card, `python -m pytest tests/ -m gpu` keeps the GPU platform for them.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax
import numpy as np
import pytest


def pytest_configure(config):
    if config.getoption("markexpr") != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_devices():
    """The GPU devices, or a skip: decided when the test runs, never at
    import, so every xdist worker collects the same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run on the card: pytest -m gpu)")
    return devs


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
