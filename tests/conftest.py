"""Test configuration.

Device-path tests run on a virtual 8-device CPU mesh so multi-device
sharding is exercised without a GPU.  These env vars must be set
before the first ``import jax`` anywhere in the test process, and
*override* any platform set in the environment.  Tests marked ``gpu``
compile kernels for the card and compare executors there; they skip
on the CPU and run with ``NXS_TEST_PLATFORM=cuda pytest -m gpu``
(chip_smoke.py runs that lane first).
"""

import os
import sys

import pytest

_platform = os.environ.get("NXS_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# The jaxtyping pytest plugin imports jax before this conftest runs,
# which snapshots JAX_PLATFORMS into jax.config before we can set the
# environment -- override the config value directly (the XLA backend
# itself is not initialized until first use, so this still applies).
import jax  # noqa: E402

jax.config.update("jax_platforms", _platform)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running stress test (deselect with "
        "-m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (run with NXS_TEST_PLATFORM=cuda "
        "pytest -m gpu)")


@pytest.fixture
def gpu():
    """The first device, which must be a GPU; skips the test otherwise
    (decided here, at run time, never while modules import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the first device is {dev.platform}")
    return dev
