"""Descending-order extension (the reference is ascending-only)."""
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_radix_sort as trs
from tpu_radix_sort.models.golden import golden_sort


@pytest.mark.parametrize("method", ["auto", "xla"])
def test_descending_keys(rng, method):
    k = rng.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
    got = np.asarray(trs.sort(jnp.asarray(k), descending=True, method=method))
    np.testing.assert_array_equal(got, golden_sort(k, descending=True))
    assert (got[:-1] >= got[1:]).all()


@pytest.mark.parametrize("bit_count", [4, 8, 24])
def test_descending_masked_keys_only(rng, bit_count):
    # masked keys-only descending: the full key rides as the payload
    k = rng.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
    got = np.asarray(
        trs.sort(jnp.asarray(k), descending=True, bit_count=bit_count))
    np.testing.assert_array_equal(
        got, golden_sort(k, descending=True, bit_count=bit_count))


def test_descending_kv_stable_masked_subcount(rng):
    n = 4000
    k = rng.integers(0, 2**6, n, dtype=np.uint64).astype(np.uint32)  # dupes
    v = np.arange(n, dtype=np.uint32)
    gk, gv = trs.sort(jnp.asarray(k), jnp.asarray(v), descending=True)
    rk, rv = golden_sort(k, v, descending=True)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)  # stability

    k2 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    got = trs.sort(jnp.asarray(k2), descending=True, bit_count=8, count=2777)
    np.testing.assert_array_equal(
        np.asarray(got), golden_sort(k2, descending=True, bit_count=8, count=2777)
    )


def test_descending_float(rng):
    f = rng.random(3000, dtype=np.float32).astype(np.float32)
    got = np.asarray(trs.sort(jnp.asarray(f), descending=True))
    np.testing.assert_array_equal(got, golden_sort(f, descending=True))
