"""Batched per-row sorts (`sort_batched` / `argsort_batched`) vs NumPy.

Extension past the reference (single flat buffer per sort): each row of a
(B, n) array sorts independently (`lax.sort` along the last axis, see
`ops/batched.py`). Oracle: NumPy stable per-row sort/argsort.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_radix_sort as trs


@pytest.fixture
def rng():
    return np.random.default_rng(20260819)


def _ref(k, bit_count=32, descending=False):
    mask = np.uint32(0xFFFFFFFF if bit_count == 32 else (1 << bit_count) - 1)
    mk = k.view(np.uint32) & mask
    if descending:
        mk = mk ^ mask
    order = np.argsort(mk, axis=1, kind="stable")
    return np.take_along_axis(k, order, axis=1), order.astype(np.uint32)


def test_batched_keys_and_values(rng):
    B, n = 7, 300
    k = rng.integers(0, 2**32, (B, n), dtype=np.uint64).astype(np.uint32)
    k[2] = k[2] % 5  # duplicate-heavy row: per-row stability load
    v = np.tile(np.arange(n, dtype=np.uint32), (B, 1))
    ref_k, ref_o = _ref(k)
    np.testing.assert_array_equal(
        np.asarray(trs.sort_batched(jnp.asarray(k))), ref_k)
    ok, ov = trs.sort_batched(jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(np.asarray(ok), ref_k)
    np.testing.assert_array_equal(np.asarray(ov), ref_o)
    np.testing.assert_array_equal(
        np.asarray(trs.argsort_batched(jnp.asarray(k))), ref_o)
    # generic (non-rank) payload: arbitrary values co-move
    pay = rng.integers(0, 2**32, (B, n), dtype=np.uint64).astype(np.uint32)
    okp, ovp = trs.sort_batched(jnp.asarray(k), jnp.asarray(pay))
    np.testing.assert_array_equal(np.asarray(okp), ref_k)
    np.testing.assert_array_equal(
        np.asarray(ovp), np.take_along_axis(pay, ref_o, axis=1))


def test_batched_masked_and_descending(rng):
    # masked keys carry the full word per row; descending flips key bits;
    # odd row lengths
    B, n = 7, 257
    k = rng.integers(0, 2**32, (B, n), dtype=np.uint64).astype(np.uint32)
    for desc in (False, True):
        ref_k, _ = _ref(k, bit_count=16, descending=desc)
        out = trs.sort_batched(jnp.asarray(k), bit_count=16, descending=desc)
        np.testing.assert_array_equal(np.asarray(out), ref_k, err_msg=str(desc))
    k2 = rng.integers(0, 2**32, (32, 130), dtype=np.uint64).astype(np.uint32)
    ref2, _ = _ref(k2, bit_count=28)
    out2 = trs.sort_batched(jnp.asarray(k2), bit_count=28)
    np.testing.assert_array_equal(np.asarray(out2), ref2)
    # long rows, few of them
    k3 = rng.integers(0, 2**32, (3, 4000), dtype=np.uint64).astype(np.uint32)
    out3 = trs.sort_batched(jnp.asarray(k3))
    np.testing.assert_array_equal(np.asarray(out3), np.sort(k3, axis=1))
    # odd batch count with tiny rows
    k4 = rng.integers(0, 2**32, (5, 64), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(trs.sort_batched(jnp.asarray(k4))), np.sort(k4, axis=1))


def test_batched_total_order_and_dtypes(rng):
    B, n = 4, 200
    f = ((rng.random((B, n)) - 0.5) * 1e6).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(trs.sort_batched(jnp.asarray(f), total_order=True)),
        np.sort(f, axis=1, kind="stable"))
    i = rng.integers(-(2**30), 2**30, (B, n), dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(trs.sort_batched(jnp.asarray(i), total_order=True)),
        np.sort(i, axis=1, kind="stable"))


def test_batched_xla_parity(rng):
    B, n = 6, 222
    k = rng.integers(0, 2**32, (B, n), dtype=np.uint64).astype(np.uint32)
    v = np.tile(np.arange(n, dtype=np.uint32), (B, 1))
    for kwargs in ({}, {"bit_count": 12, "descending": True}):
        ref_k, ref_o = _ref(k, **kwargs)
        for method in ("auto", "xla"):
            a = trs.sort_batched(jnp.asarray(k), jnp.asarray(v),
                                 method=method, **kwargs)
            np.testing.assert_array_equal(np.asarray(a[0]), ref_k)
            np.testing.assert_array_equal(np.asarray(a[1]), ref_o)


def test_batched_validation():
    with pytest.raises(ValueError):
        trs.sort_batched(jnp.zeros(8, jnp.uint32))  # 1-D
    with pytest.raises(ValueError):
        trs.sort_batched(jnp.zeros((2, 8), jnp.uint32), method="radix")
    # uint16 became a supported key dtype in round 5 (widened path); uint8
    # remains outside the key-dtype surface
    with pytest.raises(TypeError):
        trs.sort_batched(jnp.zeros((2, 8), jnp.uint8))
    with pytest.raises(ValueError):
        trs.sort_batched(jnp.zeros((2, 8), jnp.uint32),
                         jnp.zeros((2, 4), jnp.uint32))
