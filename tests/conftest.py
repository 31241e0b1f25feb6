"""Test harness configuration.

Forces JAX onto the CPU backend with 8 virtual devices BEFORE jax is imported,
so multi-device sharding tests (mesh/pjit/shard_map) run anywhere — the
pattern the driver also uses for the multi-device dry run.
"""

import os

# The CPU backend unless the caller names another platform (the card's
# tests: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/). A pytest plugin
# may import jax BEFORE this conftest runs, so env vars set here can already
# be bound — jax.config.update below is what takes effect.
platforms = os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from eegflow.core.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", platforms)
# Persistent compile cache: JAX_COMPILATION_CACHE_DIR when set, else the
# checkout's .jax_cache. Cache every program: the suite recompiles the same
# small models in many files and workers.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def gpu_device():
    """The first GPU JAX sees, or a skip. Tests marked ``gpu`` take this
    fixture, so the decision is made when the test runs, not at import."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py on the card)")
    return devices[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def eight_device_mesh():
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    assert len(devices) >= 8, f"expected 8 virtual devices, got {len(devices)}"
    return Mesh(np.array(devices[:8]), ("data",))
