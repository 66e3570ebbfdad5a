"""Test configuration: run on CPU with 8 virtual devices.

Multi-chip sharding tests exercise a virtual 8-device CPU mesh; timings on
the GPU are bench.py's and chip_smoke.py's job. Tests that need the GPU
carry the ``gpu`` marker and skip elsewhere; on the GPU machine
``python -m pytest -m gpu tests/`` runs them on the card (only that marker
expression leaves the platform unpinned). Flags are set before jax
initializes its backends.
"""

import os

import jax
import numpy as np
import pytest

GPU_ONLY = "gpu"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (run with `python -m pytest -m gpu tests/`)"
    )
    if config.getoption("markexpr", "") == GPU_ONLY:
        return
    # Force-override: tests run on the virtual 8-device CPU backend even on
    # a machine with a GPU.
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    # pytest plugins (jaxtyping) import jax before this runs, so pin the
    # platform through the config API as well
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The GPU devices; skips the test where JAX has none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest -m gpu tests/` on the GPU machine")
    return devices
