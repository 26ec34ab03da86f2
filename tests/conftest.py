"""Test configuration: run everything on a virtual 8-device CPU mesh.

This is the "fake backend" the reference never had (SURVEY.md §4): it lets
multi-chip sharding tests compile and execute without TPU hardware.

Installed pytest plugins may import jax before this file runs, so setting
the environment alone is not enough — `jax.config.update` works as long as
no backend has been initialized yet.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", "tests must run on the CPU backend"
assert len(jax.devices()) >= 8, "tests need the 8-device virtual CPU mesh"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
