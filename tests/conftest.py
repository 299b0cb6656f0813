"""Test environment: the CPU backend with 8 virtual devices.

Run the suite with ``JAX_PLATFORMS=cpu``: the sharded-semantics tests
(SURVEY.md §4.2) run the multi-device code paths on a simulated mesh.
Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them on the CPU backend;
``python -m pytest -m gpu tests/`` (no ``JAX_PLATFORMS``) runs them on a
machine with a card.
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where JAX finds none (decided when the
    test runs, never at import, so every worker collects the same
    tests)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (JAX finds none here)")
    return devs[0]
