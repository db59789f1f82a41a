"""Test harness: force JAX onto CPU with 8 virtual devices BEFORE jax import.

This simulates an 8-device mesh on one host (SURVEY.md §4 test strategy,
item 4) so sharding/collective tests run anywhere, and Pallas kernels run in
interpret mode. Tests that need a GPU carry the ``gpu`` marker and decide
inside the test (never at import) that there is no card here, and skip; on
the card the same checks run through ``chip_smoke.py``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def devices():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual CPU devices, got {len(devs)}"
    return devs


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
