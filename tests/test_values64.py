"""64-bit value payloads (uint64 / int64 / float64) on every sort path.

Capability superset of the reference's u32-only payload buffers
(`src/kernels/radix-sort/RadixSortBufferKernel.ts:34-36`): an 8-byte value
rides the engines as an (hi, lo) u32 column pair
(`ops/common.values_to_u32_cols`), co-permuted like any payload and
re-joined at the boundary. Requires jax x64 mode (like 64-bit keys).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_radix_sort as trs
from tpu_radix_sort.models.golden import golden_sort
from tpu_radix_sort.parallel import sharded
from jax.sharding import Mesh


@pytest.fixture(autouse=True, scope="module")
def _x64_mode():
    jax.config.update("jax_enable_x64", True)
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_x64", False)
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(20260819)


def _keys_with_dups(rng, n):
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    k[: n // 4] = 0x1234  # equal-key runs: stability must carry the payload
    return k


@pytest.mark.parametrize("vdtype", [np.uint64, np.int64, np.float64])
def test_flat_sort_wide_values_all_methods(rng, vdtype):
    n = 2048
    k = _keys_with_dups(rng, n)
    if vdtype == np.float64:
        v = rng.standard_normal(n).astype(vdtype)
    else:
        v = rng.integers(0, 2**62, n, dtype=np.uint64).astype(vdtype)
    rk, rv = golden_sort(k, v)
    for m in ("auto", "xla"):
        ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v), method=m)
        np.testing.assert_array_equal(np.asarray(ok), rk)
        np.testing.assert_array_equal(np.asarray(ov), rv)


def test_flat_sort_wide_values_options(rng):
    n = 3000  # non-pow2
    k = _keys_with_dups(rng, n)
    v = rng.integers(0, 2**64, n, dtype=np.uint64)
    # masked + descending + sub-count: full option surface with wide payload
    c = 2222
    rk, rv = golden_sort(k, v, count=c, bit_count=12, descending=True)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v), count=c, bit_count=12,
                      descending=True)
    np.testing.assert_array_equal(np.asarray(ok), rk)
    np.testing.assert_array_equal(np.asarray(ov), rv)
    # check_order passthrough keeps the wide payload byte-exact
    ks = golden_sort(k)
    okk, ovv = trs.sort(jnp.asarray(ks), jnp.asarray(v), check_order=True)
    np.testing.assert_array_equal(np.asarray(okk), ks)
    np.testing.assert_array_equal(np.asarray(ovv), v)
    # unsorted input through the gate still sorts
    okk, ovv = trs.sort(jnp.asarray(k), jnp.asarray(v), check_order=True)
    rk2, rv2 = golden_sort(k, v)
    np.testing.assert_array_equal(np.asarray(okk), rk2)
    np.testing.assert_array_equal(np.asarray(ovv), rv2)


def test_wide_keys_and_wide_values(rng):
    n = 2048
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    k[: n // 3] = np.uint64(5) << np.uint64(32)  # hi-word dups
    v = rng.standard_normal(n).astype(np.float64)
    rk, rv = golden_sort(k, v)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(np.asarray(ok), rk)
    np.testing.assert_array_equal(np.asarray(ov), rv)


def test_batched_and_segmented_wide_values(rng):
    B, nr = 8, 200  # non-pow2 rows
    kb = _keys_with_dups(rng, B * nr).reshape(B, nr)
    vb = rng.integers(0, 2**64, (B, nr), dtype=np.uint64)
    order = np.argsort(kb, axis=1, kind="stable")
    for m in ("auto", "xla"):
        okb, ovb = trs.sort_batched(jnp.asarray(kb), jnp.asarray(vb), method=m)
        np.testing.assert_array_equal(
            np.asarray(okb), np.take_along_axis(kb, order, 1))
        np.testing.assert_array_equal(
            np.asarray(ovb), np.take_along_axis(vb, order, 1))
    # ragged segments
    n = B * nr
    offs = np.array([0, 1, 1, 500, 512, n], dtype=np.int32)
    kf, vf = kb.reshape(n), vb.reshape(n)
    ek, ev = kf.copy(), vf.copy()
    for i in range(len(offs) - 1):
        lo, hi = offs[i], offs[i + 1]
        o = np.argsort(kf[lo:hi], kind="stable")
        ek[lo:hi], ev[lo:hi] = kf[lo:hi][o], vf[lo:hi][o]
    for m in ("auto", "xla"):
        oks, ovs = trs.sort_segments(
            jnp.asarray(kf), jnp.asarray(offs), jnp.asarray(vf), method=m)
        np.testing.assert_array_equal(np.asarray(oks), ek)
        np.testing.assert_array_equal(np.asarray(ovs), ev)


def test_mesh_wide_values_both_strategies(rng):
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("x",))
    n = 4096
    k = _keys_with_dups(rng, n)
    v = rng.integers(0, 2**64, n, dtype=np.uint64)
    rk, rv = golden_sort(k, v)
    kj, vj = sharded(mesh, "x", jnp.asarray(k)), sharded(mesh, "x", jnp.asarray(v))
    for m in ("mesh", "exchange"):
        ok, ov = trs.sort(kj, vj, mesh=mesh, method=m)
        np.testing.assert_array_equal(np.asarray(ok), rk)
        np.testing.assert_array_equal(np.asarray(ov), rv)


def test_wide_value_error_paths(rng):
    n = 256
    k = _keys_with_dups(rng, n)
    v = rng.integers(0, 2**64, n, dtype=np.uint64)
    # values must match the keys' shape
    with pytest.raises(ValueError):
        trs.sort(jnp.asarray(k), jnp.asarray(v)[:-1])
    with pytest.raises(ValueError):
        trs.sort_batched(jnp.asarray(k).reshape(2, -1),
                         jnp.asarray(v).reshape(4, -1))
    # 2-byte values are not a payload width
    with pytest.raises(TypeError):
        trs.sort(jnp.asarray(k), jnp.asarray(np.zeros(n, np.float16)))


def test_wide_value_guard_without_x64():
    # raw 64-bit numpy values with x64 off must refuse, not truncate
    jax.config.update("jax_enable_x64", False)
    try:
        k = np.arange(128, dtype=np.uint32)
        v = np.arange(128, dtype=np.uint64)
        with pytest.raises(TypeError):
            trs.sort(jnp.asarray(k), v)
    finally:
        jax.config.update("jax_enable_x64", True)
