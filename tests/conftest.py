"""Test harness: the CPU backend unless JAX_PLATFORMS names another (the
driver runs the suite with JAX_PLATFORMS=cpu; the `gpu`-marked tests run
on the card with JAX_PLATFORMS=cuda), 8 virtual CPU devices so the
multi-device tests run on a host-device mesh, and float64 enabled for the
oracle path."""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip the test unless JAX's backend is the GPU — decided when the
    test runs, never at import or collection."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU: run with JAX_PLATFORMS=cuda on the card")
