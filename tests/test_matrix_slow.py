"""Reference-breadth randomized configuration sweep (`-m slow`).

The reference integrity test draws *hundreds* of random configurations:
every workgroup shape (x,y) in {2..256}^2, element counts 10^2..10^7 with
+-10% jitter, a random sub-count, and fresh random flag draws each time
(`/root/reference/example/tests.ts:19-42`). This file is that matrix: a
few hundred drawn configs over count decades, sub-counts, flags, dtypes
and methods, each checked byte-exactly against the golden model. (Tile
shape has no analogue: XLA chooses its own.)

The decades stop at 10^5 (the 10^6+ region runs on the GPU in
chip_smoke.py); `jax.clear_caches()` brackets the sweep in chunks because
hundreds of fresh XLA:CPU pipelines in one process have ended in the
native segfault documented in conftest.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_radix_sort as trs
from tpu_radix_sort.models.golden import golden_sort

pytestmark = pytest.mark.slow

CLEAR_EVERY = 10  # compiled-executable accumulation guard (conftest.py)


def _draw_keys(rng, n, dtype):
    if dtype == "uint32":
        return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if dtype == "float32":
        return (rng.random(n) * 1e6).astype(np.float32)  # non-negative
    if dtype == "int32":
        return rng.integers(0, 2**31, n, dtype=np.int64).astype(np.int32)
    raise ValueError(dtype)


def _draw_count(rng):
    exp = int(rng.integers(2, 6))  # decades 10^2..10^5
    return max(2, int(10**exp * (0.9 + 0.2 * rng.random())))  # +-10% jitter


def _run_config(rng, i, method):
    n = _draw_count(rng)
    count = n if rng.random() < 0.5 else int(rng.integers(0, n + 1))
    bit_count = 32 if rng.random() < 0.6 else int(rng.choice(
        [4, 8, 12, 16, 20, 24, 28]))
    dtype = str(rng.choice(["uint32", "uint32", "float32", "int32"]))
    check_order = rng.random() < 0.25
    descending = rng.random() < 0.15
    total_order = rng.random() < 0.15
    with_values = rng.random() < 0.5
    presorted = rng.random() < 0.15  # exercise the early-exit path too

    k = _draw_keys(rng, n, dtype)
    if presorted:
        k = golden_sort(k)
    flags = dict(count=count, bit_count=bit_count, descending=descending,
                 total_order=total_order)
    cfg = (i, method, n, count, bit_count, dtype, check_order, descending,
           total_order, with_values)
    if with_values:
        if rng.random() < 0.5:
            v = np.arange(n, dtype=np.uint32)  # the reference's payload
        else:
            v = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v),
                          check_order=check_order, method=method, **flags)
        rk, rv = golden_sort(k, v, **flags)
        np.testing.assert_array_equal(np.asarray(ok), rk, err_msg=str(cfg))
        np.testing.assert_array_equal(np.asarray(ov), rv, err_msg=str(cfg))
    else:
        out = trs.sort(jnp.asarray(k), check_order=check_order, method=method,
                       **flags)
        ref = golden_sort(k, **flags)
        np.testing.assert_array_equal(np.asarray(out), ref, err_msg=str(cfg))


@pytest.mark.parametrize("method,seed", [("auto", 20260817),
                                         ("xla", 20260818)])
def test_breadth_sweep(method, seed):
    rng = np.random.default_rng(seed)
    for i in range(200):
        if i % CLEAR_EVERY == 0:
            jax.clear_caches()
        _run_config(rng, i, method)
    jax.clear_caches()


def test_breadth_sweep_through_kernel_class():
    """The sweep driven through the reference-shaped kernel-class API
    (`RadixSortKernel`), one constructed instance per drawn config."""
    rng = np.random.default_rng(20260819)
    for i in range(24):
        if i % 6 == 0:
            jax.clear_caches()
        n = int(rng.integers(100, 1500))
        count = n if rng.random() < 0.5 else int(rng.integers(0, n + 1))
        bit_count = int(rng.choice([4, 8, 16, 32]))
        check_order = rng.random() < 0.3
        with_values = rng.random() < 0.5
        k = _draw_keys(rng, n, "uint32")
        if rng.random() < 0.3:  # few distinct keys
            k = (k & np.uint32(3)).astype(np.uint32)
        kern = trs.RadixSortKernel(
            count=count, has_values=with_values, bit_count=bit_count,
            check_order=check_order,
        )
        cfg = (i, n, count, bit_count, check_order, with_values)
        if with_values:
            v = np.arange(n, dtype=np.uint32)
            ok, ov = kern.dispatch(jnp.asarray(k), jnp.asarray(v))
            rk, rv = golden_sort(k, v, count=count, bit_count=bit_count)
            np.testing.assert_array_equal(np.asarray(ok), rk, err_msg=str(cfg))
            np.testing.assert_array_equal(np.asarray(ov), rv, err_msg=str(cfg))
        else:
            out = kern.dispatch(jnp.asarray(k))
            ref = golden_sort(k, count=count, bit_count=bit_count)
            np.testing.assert_array_equal(np.asarray(out), ref,
                                          err_msg=str(cfg))
    jax.clear_caches()
