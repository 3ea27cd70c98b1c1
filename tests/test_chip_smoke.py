"""The measurement helpers behind chip_smoke.py, and one phase of it on
the card.

CPU tests cover what decides a device measurement's validity: refusing a
non-GPU platform, parsing `nvidia-smi`, reading which sort implementation
the optimized HLO holds, the memory-peak table and the compile-cache path
rule. The `gpu`-marked test runs a chip_smoke phase and skips without a
card.
"""
import os
import sys

import jax
import numpy as np
import pytest

from tpu_radix_sort.runtime import device as dev

# Excerpts of optimized HLO as XLA prints it: a CUB pair sort on the GPU,
# XLA's own 3-operand sort, and a program with no sort.
HLO_CUB = """
ENTRY %main (p0: u32[67108864], p1: u32[67108864]) -> (u32[67108864], u32[67108864]) {
  %custom-call.1 = (u32[67108864]{0}, u32[67108864]{0}, u8[1048576]{0}) custom-call(u32[67108864]{0} %p0, u32[67108864]{0} %p1), custom_call_target="__cub$DeviceRadixSort", metadata={op_name="jit(sort)/sort"}, backend_config="\\b\\001"
}
"""
HLO_XLA_SORT = """
ENTRY %main (p0: u32[4096], p1: u32[4096], p2: u32[4096]) -> (u32[4096], u32[4096], u32[4096]) {
  %sort.3 = (u32[4096]{0}, u32[4096]{0}, u32[4096]{0}) sort(u32[4096]{0} %p0, u32[4096]{0} %p1, u32[4096]{0} %p2), dimensions={0}, is_stable=true, to_apply=%compare.7, metadata={op_name="jit(_sort_jit)/sort"}
}
"""
HLO_KEYS_ONLY_XLA = """
  %sort.1 = u32[100]{0} sort(u32[100]{0} %p0), dimensions={0}, to_apply=%lt
"""
HLO_NONE = """
ENTRY %main (p0: u32[8]) -> u32[8] {
  %add = u32[8]{0} add(u32[8]{0} %p0, u32[8]{0} %c), metadata={op_name="jit(cumsum)/sort"}
}
"""


@pytest.mark.parametrize("platform", ["cpu", "tpu", "METAL"])
def test_require_gpu_refuses_other_platforms(platform):
    with pytest.raises(dev.NoAcceleratorError, match="no GPU"):
        dev.require_gpu(platform)
    dev.require_gpu("gpu")


def test_require_gpu_reads_jax_devices():
    # the suite runs on the CPU: the default device must be refused
    with pytest.raises(dev.NoAcceleratorError):
        dev.require_gpu()


def test_parse_nvidia_smi():
    text = "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 400.00 W\n\n"
    assert dev.parse_nvidia_smi(text) == [
        ("NVIDIA H100 80GB HBM3", "700.00 W"),
        ("NVIDIA H100 80GB HBM3", "400.00 W"),
    ]
    # a comma inside the name stays in the name
    assert dev.parse_nvidia_smi("Card, rev 2, 350.00 W") == [
        ("Card, rev 2", "350.00 W")]
    with pytest.raises(ValueError):
        dev.parse_nvidia_smi("no separator here")


@pytest.mark.parametrize("hlo,expect,counts", [
    (HLO_CUB, "cub x1", {"cub": 1, "xla": 0}),
    (HLO_XLA_SORT, "xla-sort x1", {"cub": 0, "xla": 1}),
    (HLO_KEYS_ONLY_XLA, "xla-sort x1", {"cub": 0, "xla": 1}),
    (HLO_CUB + HLO_XLA_SORT, "cub x1+xla-sort x1", {"cub": 1, "xla": 1}),
    (HLO_NONE, "none", {"cub": 0, "xla": 0}),
])
def test_sort_lowering_from_recorded_hlo(hlo, expect, counts):
    assert dev.sort_lowerings(hlo) == counts
    assert dev.describe_lowering(hlo) == expect


def test_sort_lowering_from_cpu_compile():
    """A real compile: XLA:CPU keeps its own sort instruction."""
    import jax.numpy as jnp

    import tpu_radix_sort as trs

    x = jnp.arange(64, dtype=jnp.uint32)[::-1]
    hlo = jax.jit(lambda a: trs.sort(a)).lower(x).compile().as_text()
    assert dev.describe_lowering(hlo).startswith("xla-sort")
    hlo = jax.jit(lambda a: a + 1).lower(x).compile().as_text()
    assert dev.describe_lowering(hlo) == "none"


def test_hbm_peak_table():
    assert dev.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError, match="no memory-bandwidth peak"):
        dev.hbm_peak("cpu")


def test_compile_cache_path_rule(monkeypatch):
    assert dev.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"
    assert dev.compile_cache_dir({}) == dev.DEFAULT_COMPILE_CACHE_DIR
    assert dev.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == (
        dev.DEFAULT_COMPILE_CACHE_DIR)
    # the default is one fixed directory inside the checkout
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert dev.DEFAULT_COMPILE_CACHE_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compile_cache_sets_only_the_directory(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    assert dev.enable_compile_cache({"JAX_COMPILATION_CACHE_DIR": "/c"}) == "/c"
    assert calls == []  # JAX reads the variable itself
    path = dev.enable_compile_cache({})
    assert calls == [("jax_compilation_cache_dir", path)]


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided here, never at import time."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("no GPU: run on the card with "
                    "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu")
    return gpus[0]


@pytest.mark.gpu
def test_chip_smoke_phase_on_gpu(gpu_device):
    """The first chip_smoke phase (2^26 u32 key+value sort) runs compiled
    on the card and matches golden byte for byte."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    phase = next(chip_smoke.single_card_phases(np.random.default_rng(0)))
    with jax.default_device(gpu_device):
        assert chip_smoke.run_phase(phase, gpu_device.device_kind,
                                    "test") is True
