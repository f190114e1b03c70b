"""Test env: an 8-device virtual CPU mesh, set before JAX initializes.

Mesh/collective logic is exercised without accelerators, per the
multi-device test strategy in SURVEY.md section 4. Tests run on the CPU
(`JAX_PLATFORMS=cpu`). Tests marked `gpu` need an NVIDIA GPU and skip
elsewhere; on a GPU machine run them with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_chip_smoke.py`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this process has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip(
            "needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_chip_smoke.py"
        )


@pytest.fixture
def cpu_device():
    return jax.devices("cpu")[0]
