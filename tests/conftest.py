"""Test configuration: the CPU with an 8-device virtual mesh.

Sharding logic is validated on a virtual CPU mesh
(--xla_force_host_platform_device_count=8); see SURVEY.md §4.  JAX runs
on the CPU unless ``JAX_PLATFORMS`` names other platforms: the tests
marked ``gpu`` need ``JAX_PLATFORMS=cuda,cpu`` and ask for the card
themselves, in the ``gpu_device`` fixture.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError as e:
        pytest.skip(f"needs a GPU: {e}")
