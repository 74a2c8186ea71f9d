"""Test harness: an 8-virtual-device CPU platform and float64.

The solvers are platform-agnostic traced code; tests run them on CPU (with
x64 for tight-tolerance oracles, Pallas kernels interpreted) and validate
multi-device sharding on the virtual mesh.  Tests marked ``gpu`` need the
card and skip elsewhere; run them there with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

# Must be set before the XLA CPU client initializes.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def mesh8():
    from jax.sharding import Mesh
    import numpy as np
    devs = np.array(jax.devices("cpu")[:8]).reshape(4, 2)
    return Mesh(devs, ("dp", "tp"))


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/")
