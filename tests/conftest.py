"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices so mesh/halo logic is
exercised without a multi-GPU host (SURVEY.md section 4 'implication'), and with x64
enabled so golden parity can be checked at the reference's own 1e-6
threshold (the reference computes in float64; %lf text goldens carry 6
decimals).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # the tests run on the CPU backend, never the GPU
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# also pinned through the config, in case jax was imported before the env
# var was set
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from optical_flow_tpu.utils import goldens  # noqa: E402
from optical_flow_tpu.utils.compile_cache import enable_persistent_cache  # noqa: E402

# Persistent on-disk compile cache: the 8-device sharded-pyramid programs
# dominate CI wall time (5 tests, ~15 min of pure XLA:CPU compilation);
# caching them cuts a fresh-checkout suite re-run to a fraction. Cache
# keys include backend+flags, so CPU test entries coexist with GPU
# entries in the same directory.
enable_persistent_cache()


@pytest.fixture(scope="session")
def reference_dir():
    ref = goldens.reference_dir()
    if ref is None:
        pytest.skip("reference checkout not available")
    return ref


@pytest.fixture(scope="session")
def table_pair(reference_dir):
    return goldens.load_table_pair()


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(1234)


def require_cv2():
    try:
        import cv2  # noqa: F401

        return cv2
    except ImportError:
        pytest.skip("cv2 oracle not available")
