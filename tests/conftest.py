"""Test session setup.

Without ``JAX_PLATFORMS`` in the environment the tests run on the CPU, with
8 virtual devices for the multi-device sharding tests
(``--xla_force_host_platform_device_count=8``, the standard JAX fake-mesh
trick, SURVEY.md §4.3).  ``JAX_PLATFORMS=cuda,cpu`` runs them on the GPU instead,
where the ``gpu``-marked tests also run; elsewhere those skip (``gpu``
fixture).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu on the card)")
    return jax.devices()[0]
