"""16-bit key dtypes (uint16 / int16 / float16 / bfloat16) vs the oracle.

Extension past the reference (32-bit-only buffers): 16-bit keys widen to
their u16 bit pattern in a u32 lane (`ops/common.to_sortable_u32`, the
SURVEY §7 "monotone bijection" pattern one width down), so every option
and routing works unchanged; `bit_count` caps at 16.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

import tpu_radix_sort as trs
from tpu_radix_sort.models.golden import golden_sort, golden_is_sorted
from tpu_radix_sort.parallel import sharded
from jax.sharding import Mesh


@pytest.fixture
def rng():
    return np.random.default_rng(20260819)


DTYPES = (np.uint16, np.int16, np.float16, ml_dtypes.bfloat16)


def _keys(rng, n, dtype):
    if dtype == np.uint16:
        k = rng.integers(0, 2**16, n).astype(np.uint16)
    elif dtype == np.int16:
        k = rng.integers(-(2**15), 2**15, n).astype(np.int16)
    else:
        k = rng.standard_normal(n).astype(dtype)
    k[: n // 8] = k[0]  # equal-key runs: stability must hold
    return k


def _eq(a, b):
    # bit-pattern equality (NaN-safe, bfloat16-safe)
    np.testing.assert_array_equal(
        np.asarray(a).view(np.uint16), np.asarray(b).view(np.uint16)
    )


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["plain", "descending", "total_order"])
def test_sort16_vs_golden(rng, dtype, variant):
    kw = {} if variant == "plain" else {variant: True}
    for n in (100, 3000):
        k = _keys(rng, n, dtype)
        v = np.arange(n, dtype=np.uint32)
        ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v), **kw)
        rk, rv = golden_sort(k, v, **kw)
        _eq(ok, rk)
        np.testing.assert_array_equal(np.asarray(ov), rv)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sort16_total_order_negatives(rng, dtype):
    k = _keys(rng, 2048, dtype)
    got = trs.sort(jnp.asarray(k), total_order=True)
    _eq(got, np.sort(k))
    assert golden_is_sorted(np.asarray(got), total_order=True)
    assert bool(trs.is_sorted(got, total_order=True))


def test_sort16_option_surface(rng):
    n = 3000
    k = _keys(rng, n, np.uint16)
    v = np.arange(n, dtype=np.uint32)
    # masked + descending + sub-count + values, vs golden
    rk, rv = golden_sort(k, v, bit_count=8, descending=True, count=2222)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v), bit_count=8,
                      descending=True, count=2222)
    _eq(ok, rk)
    np.testing.assert_array_equal(np.asarray(ov), rv)
    # flagged checks verify the flagged output
    sd = trs.sort(jnp.asarray(k), descending=True)
    assert bool(trs.is_sorted(sd, descending=True))
    assert not bool(trs.is_sorted(sd))
    # argsort (rank-payload path)
    a = np.asarray(trs.argsort(jnp.asarray(k)))
    np.testing.assert_array_equal(k[a], np.sort(k, kind="stable"))
    # check_order passthrough on sorted input
    ks = golden_sort(k)
    _eq(trs.sort(jnp.asarray(ks), check_order=True), ks)
    # 64-bit values on 16-bit keys compose
    jax.config.update("jax_enable_x64", True)
    try:
        jax.clear_caches()
        v64 = rng.integers(0, 2**64, n, dtype=np.uint64)
        rk64, rv64 = golden_sort(k, v64)
        ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v64))
        _eq(ok, rk64)
        np.testing.assert_array_equal(np.asarray(ov), rv64)
    finally:
        jax.config.update("jax_enable_x64", False)
        jax.clear_caches()
    # bit_count > native width must refuse
    with pytest.raises(ValueError):
        trs.sort(jnp.asarray(k), bit_count=20)
    with pytest.raises(ValueError):
        trs.is_sorted(jnp.asarray(k), bit_count=32)


def test_sort16_batched_segmented(rng):
    kb = _keys(rng, 8 * 200, np.int16).reshape(8, 200)
    got = trs.sort_batched(jnp.asarray(kb), total_order=True)
    _eq(got, np.sort(kb, axis=1))
    rb = np.asarray(trs.argsort_batched(jnp.asarray(kb), total_order=True))
    np.testing.assert_array_equal(
        np.take_along_axis(kb, rb.astype(np.int64), 1), np.sort(kb, axis=1))
    n = 3000
    k = _keys(rng, n, np.uint16)
    offs = np.array([0, 1, 50, 700, n], dtype=np.int32)
    ek = k.copy()
    for i in range(len(offs) - 1):
        ek[offs[i]: offs[i + 1]] = np.sort(k[offs[i]: offs[i + 1]])
    for m in ("auto", "xla"):
        # keys-only u16 packs (seg << 16) | key into ONE column with no
        # carried full key — the packed unmask-recovery path
        _eq(trs.sort_segments(jnp.asarray(k), jnp.asarray(offs), method=m), ek)
    r = np.asarray(trs.argsort_segments(jnp.asarray(k), jnp.asarray(offs)))
    for i in range(len(offs) - 1):
        seg, rs = k[offs[i]: offs[i + 1]], r[offs[i]: offs[i + 1]]
        np.testing.assert_array_equal(seg[rs], np.sort(seg))


def test_sort16_mesh_both_strategies(rng):
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("x",))
    n = 4096
    k = _keys(rng, n, ml_dtypes.bfloat16)
    v = np.arange(n, dtype=np.uint32)
    rk, rv = golden_sort(k, v)
    kj = sharded(mesh, "x", jnp.asarray(k))
    vj = sharded(mesh, "x", jnp.asarray(v))
    for m in ("mesh", "exchange"):
        ok, ov = trs.sort(kj, vj, mesh=mesh, method=m)
        _eq(ok, rk)
        np.testing.assert_array_equal(np.asarray(ov), rv)
    # distributed checks on the native dtype
    srt = golden_sort(k)
    assert bool(trs.is_sorted(sharded(mesh, "x", jnp.asarray(srt)), mesh=mesh))
