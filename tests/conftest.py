"""Test configuration: run on the CPU with 8 virtual devices.

Multi-device sharding is validated on a virtual 8-device CPU mesh
(`--xla_force_host_platform_device_count=8`); device numbers come from
`chip_smoke.py` on the GPU, not from the unit suite. Tests marked `gpu`
need a card and skip without one (see `tests/test_chip_smoke.py`).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        yield


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    The full suite compiles many hundreds of XLA:CPU executables in one
    process; without this, accumulation has ended in a native segfault
    inside `backend_compile_and_load` (jax 0.9.0) while every module was
    green in isolation. Cache reuse matters within a module, not across.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def x64():
    """jax x64 mode for one test (64-bit keys and values need it)."""
    jax.config.update("jax_enable_x64", True)
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_x64", False)
    jax.clear_caches()

