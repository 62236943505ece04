"""Test configuration: JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU (JAX_PLATFORMS=cpu unless the environment names
another platform), with 8 virtual devices for the sharding tests. Pallas
kernels run in interpret mode against their plain references.

Tests marked `gpu` need a GPU and skip without one; run them on the card
with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs a GPU")
