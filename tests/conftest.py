"""Test configuration: force an 8-device virtual CPU mesh + enable x64.

The same ``shard_map`` code paths that run on several GPUs are exercised
on 8 virtual CPU devices (SURVEY §4). x64 is enabled so f64 oracle parity
tests are exact; library code derives dtypes from its inputs, so f32 paths
are still tested by passing explicit f32 arrays.

Must run before jax is imported anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

# Must happen before any backend initialization.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skips unless JAX sees an NVIDIA GPU (decided at run time, never at
    import: every xdist worker must collect the same tests)."""
    from mpc_rs_jax.ops import kernel_available

    if not kernel_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card via chip_smoke.py and `pytest -m gpu`")
