"""Test configuration: CPU with 8 virtual devices and x64 enabled, unless
JAX_PLATFORMS names another platform.

The CPU tests validate exact reference-parity numerics (float64 energies),
the fused kernel under the Pallas interpreter, and multi-device sharding on
a virtual CPU mesh. Tests that need the card carry the `gpu` marker and ask
for the `gpu` fixture, which decides when the test runs (never at import)
whether a GPU is there; on the card they run through `python chip_smoke.py`
or `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` or "
                    "`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` "
                    "on the card")
