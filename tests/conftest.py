"""Test configuration: an 8-virtual-device CPU platform, the `gpu` marker,
and the fixture that runs the Pallas kernels in interpret mode.

Tests run without an accelerator; multi-device sharding tests use 8
virtual CPU devices. Tests marked `gpu` compile the kernels for a real
card; they skip here and run on the card with `python -m pytest -m gpu
tests/`.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (compiled kernels); skips elsewhere"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def interpret_kernels():
    """Run the Pallas kernels in interpret mode on the CPU for one test."""
    from gemma_tpu.ops import _backend

    with _backend.interpret_kernels():
        yield


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest -m gpu tests/` on the card")
