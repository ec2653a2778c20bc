"""Test config: an 8-virtual-device CPU platform unless JAX_PLATFORMS says
otherwise, set before JAX loads.

Multi-card sharding is validated on the virtual CPU mesh (the reference's
"launch 4 EC2 instances" integration tier becomes fake-mesh configs —
SURVEY.md §4 implication).  Tests marked ``gpu`` need a card and skip
elsewhere; on a card: ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

_cache = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")
os.makedirs(_cache, exist_ok=True)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", _cache)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1.0")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a CUDA GPU (decided here, at
    run time, so every worker collects the same tests)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")
