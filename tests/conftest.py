"""Test configuration: the CPU backend with 8 virtual devices.

Tests run on the CPU, a supported platform, with
``--xla_force_host_platform_device_count=8`` so multi-device sharding
(mesh/pjit/shard_map) is exercised without several cards. This must happen
before jax initializes a backend. Code that needs the GPU is covered by
``chip_smoke.py`` on the card; tests marked ``gpu`` skip here.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# jax may already have been imported by a pytest plugin, in which case
# JAX_PLATFORMS was read at import time — override via the config API.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

# Persistent compilation cache: pipeline-level jits (slam_step & friends)
# take tens of seconds to compile on CPU; cache them across pytest runs.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from icpslam_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

# jax may already be in sys.modules (a pytest plugin can import it), but the
# backend must not have been initialized yet for the env vars to take effect.
assert jax.default_backend() == "cpu", (
    f"expected CPU backend for tests, got {jax.default_backend()}; "
    "jax was initialized before tests/conftest.py could set the platform"
)
del sys


import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop JAX's in-memory executable caches after each test module.

    A full single-process `pytest tests/` accumulates every compiled
    slam_step/run_scans variant (hundreds of MB of executables); late in
    the run XLA:CPU compiles have segfaulted under that memory pressure
    (SIGSEGV/SIGABRT inside backend_compile). The persistent disk cache
    keeps cross-module recompiles cheap; only the in-memory handles are
    dropped.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where there is none (decided per test,
    never at import, so every pytest-xdist worker collects the same
    tests)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs this on the card)")
    return devs[0]
