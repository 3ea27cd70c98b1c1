"""Prefix-sum op vs the golden oracle — mirrors the reference's
test_prefix_sum sweep (`example/tests.ts:110-182`): sizes 1..10^5 with
jitter, values in [0, 8), exclusive scan oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_radix_sort as trs
from tpu_radix_sort.models.golden import golden_prefix_sum


@pytest.mark.parametrize(
    "n", [1, 2, 7, 127, 128, 129, 1000, 4096, 12345, 100_000]
)
def test_prefix_sum_matches_oracle(rng, n):
    x = rng.integers(0, 8, n).astype(np.uint32)
    out = np.asarray(trs.prefix_sum(jnp.asarray(x)))
    assert np.array_equal(out, golden_prefix_sum(x))


def test_prefix_sum_subcount_preserves_suffix(rng):
    x = rng.integers(0, 8, 1000).astype(np.uint32)
    out = np.asarray(trs.prefix_sum(jnp.asarray(x), count=600))
    ref = golden_prefix_sum(x, count=600)
    assert np.array_equal(out, ref)
    assert np.array_equal(out[600:], x[600:])


def test_prefix_sum_u32_wraparound():
    x = np.array([0xFFFFFFFF, 0xFFFFFFFF, 5, 7], dtype=np.uint32)
    out = np.asarray(trs.prefix_sum(jnp.asarray(x)))
    assert np.array_equal(out, golden_prefix_sum(x))


def test_prefix_sum_inclusive(rng):
    x = rng.integers(0, 100, 777).astype(np.uint32)
    out = np.asarray(trs.prefix_sum(jnp.asarray(x), inclusive=True))
    ref = np.cumsum(x.astype(np.uint64)).astype(np.uint32)
    assert np.array_equal(out, ref)


def test_prefix_sum_multiblock(rng):
    x = rng.integers(0, 8, 200_000).astype(np.uint32)
    out = np.asarray(trs.prefix_sum(jnp.asarray(x)))
    assert np.array_equal(out, golden_prefix_sum(x))


@pytest.mark.parametrize("dtype", ["uint32", "int32"])
@pytest.mark.parametrize("n", [257, 4096, 33000])
def test_prefix_sum_kernel_sizes(rng, n, dtype):
    """The functional op and the kernel class agree with the oracle across
    sizes and both item dtypes; values wrap past 2^32 (int32 items scan
    their u32 bit patterns, like the reference's u32 buffers)."""
    x = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    x = x.view(dtype)
    ref = golden_prefix_sum(x.view(np.uint32)).view(dtype)
    out = np.asarray(trs.prefix_sum(jnp.asarray(x)))
    assert np.array_equal(out, ref), n
    kern = trs.PrefixSumKernel(count=n)
    assert np.array_equal(np.asarray(kern.dispatch(jnp.asarray(x))), ref), n


def test_prefix_sum_kernel_class(rng):
    x = rng.integers(0, 8, 5000).astype(np.uint32)
    kern = trs.PrefixSumKernel(count=5000)
    out = np.asarray(kern.dispatch(jnp.asarray(x)))
    assert np.array_equal(out, golden_prefix_sum(x))


def test_prefix_sum_rejects_bad_input():
    with pytest.raises(TypeError):
        trs.prefix_sum(jnp.zeros(8, jnp.float32))
    with pytest.raises(ValueError):
        trs.prefix_sum(jnp.zeros((2, 2), jnp.uint32))
    with pytest.raises(ValueError):
        trs.prefix_sum(jnp.zeros(8, jnp.uint32), count=9)


@pytest.mark.parametrize("inclusive", [False, True])
@pytest.mark.parametrize("n", [1, 1000, 65536, 65537, 3 * 65536 - 5])
def test_gpu_scan_kernels_interpret(rng, n, inclusive):
    """The GPU path (Pallas Triton reduce-then-scan, `ops/scan_triton.py`)
    in the Pallas interpreter: padding to whole CHUNKs, the carry across
    tiles and programs, and u32 wraparound, vs the oracle."""
    from tpu_radix_sort.ops import scan

    x = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    out = np.asarray(scan.scan_gpu(jnp.asarray(x), inclusive=inclusive,
                                   interpret=True))
    ref = (np.cumsum(x, dtype=np.uint32) if inclusive
           else golden_prefix_sum(x))
    assert np.array_equal(out, ref)


def test_gpu_scan_requires_whole_chunks():
    from tpu_radix_sort.ops import scan_triton

    with pytest.raises(ValueError, match="multiple"):
        scan_triton.scan_u32(jnp.zeros(scan_triton.CHUNK + 1, jnp.uint32),
                             interpret=True)


@pytest.mark.parametrize("platform,triton", [("cuda", True),
                                             ("cpu", False)])
def test_prefix_sum_kernel_choice_per_platform(platform, triton):
    """Lowered for CUDA, prefix_sum holds the two Triton kernels (and
    nothing else scans); lowered for the CPU it holds none — the branch is
    chosen at lowering time, so no call interprets a kernel."""
    import jax

    x = jnp.arange(70000, dtype=jnp.uint32)
    text = jax.jit(lambda a: trs.prefix_sum(a)).trace(x).lower(
        lowering_platforms=(platform,)).as_text()
    assert ("gpu.triton" in text) is triton
    assert ("scan_reduce" in text and "scan_blocks" in text) is triton
