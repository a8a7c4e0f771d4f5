"""Test configuration.

The suite runs on the CPU with 8 virtual devices (so multi-device
sharding code paths run without accelerators) unless JAX_PLATFORMS
names another platform.  Tests marked `gpu` need a CUDA device; the
`gpu_device` fixture skips them elsewhere."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache (utils/cache.py): XLA compiles dominate
# the suite's wall time; reruns on the same machine reuse them.
from pointcloudhookup_tpu.utils.cache import setup_compilation_cache  # noqa: E402

setup_compilation_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test when there is none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU (platform is {devs[0].platform})")
    return devs[0]


@pytest.fixture
def four_devices():
    """Four devices of one platform (virtual CPU devices here); skips
    when fewer exist."""
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip(f"needs >= 4 devices, have {len(devs)}")
    return devs[:4]


@pytest.fixture
def corridor(rng):
    """Small synthetic corridor sized for the CPU test backend (~6.2k
    points; pairs with capacity 8192 in the extraction tests)."""
    from pointcloudhookup_tpu.io.synthetic import synthetic_corridor

    return synthetic_corridor(
        rng, n_ground=4000, n_veg=800, pts_per_tower=400, extent=250.0
    )
