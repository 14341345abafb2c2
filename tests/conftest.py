"""Test harness config: force an 8-device virtual CPU mesh.

Tests run the same SPMD code paths as real pods via
`--xla_force_host_platform_device_count=8` (SURVEY.md §4d).  Must be set
before jax initializes.
"""

import os

# Hard-set, not setdefault: tests run on the local CPU backend even on a
# machine with a GPU, so override both the env var and (below) the
# already-applied config.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from csgn_tpu.context import Context  # noqa: E402


@pytest.fixture(scope="session")
def ctx() -> Context:
    """The reference tests' Context(1247, 16) (tests/basic_operations.cpp:14)."""
    return Context(1247, 16)


@pytest.fixture(scope="session")
def small_ctx() -> Context:
    """A small context for cheap property tests."""
    return Context(95, 4)


@pytest.fixture
def rng():
    return jax.random.key(0)


def pytest_configure(config):
    np.random.seed(0)
