"""Segmented (ragged) sorts vs a per-segment NumPy oracle.

Extension past the reference: `sort_segments`/`argsort_segments`
(`ops/segmented.py`) sort CSR-style variable-length segments in place via
a composite (segment_id, key) lexicographic key through the same engine.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_radix_sort as trs


@pytest.fixture
def rng():
    return np.random.default_rng(20260820)


def _ref(k, offs, v=None, bit_count=32, descending=False):
    k = k.copy()
    vv = None if v is None else v.copy()
    mask = np.uint32(0xFFFFFFFF if bit_count == 32 else (1 << bit_count) - 1)
    for a, b in zip(offs[:-1], offs[1:]):
        mk = k[a:b].view(np.uint32) & mask
        if descending:
            mk = mk ^ mask
        o = np.argsort(mk, kind="stable")
        k[a:b] = k[a:b][o]
        if vv is not None:
            vv[a:b] = v[a:b][o]
    return (k, vv) if v is not None else k


def _offsets(rng, n, cuts, with_empty=True):
    offs = np.unique(np.concatenate(
        [[0], rng.choice(np.arange(1, n), size=cuts, replace=False), [n]]
    )).astype(np.int32)
    if with_empty:  # duplicate one boundary: an empty segment mid-array
        offs = np.concatenate([offs[:3], [offs[2]], offs[3:]]).astype(np.int32)
    return offs


def test_segments_keys_values_argsort(rng):
    n = 2000
    offs = _offsets(rng, n, 12)
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    k[offs[4]:offs[5]] %= 7  # duplicate-heavy segment: stability load
    v = np.arange(n, dtype=np.uint32)
    np.testing.assert_array_equal(
        np.asarray(trs.sort_segments(jnp.asarray(k), jnp.asarray(offs))),
        _ref(k, offs))
    ok, ov = trs.sort_segments(jnp.asarray(k), jnp.asarray(offs),
                               jnp.asarray(v))
    rk, rv = _ref(k, offs, v)
    np.testing.assert_array_equal(np.asarray(ok), rk)
    np.testing.assert_array_equal(np.asarray(ov), rv)
    ranks = trs.argsort_segments(jnp.asarray(k), jnp.asarray(offs))
    starts = np.concatenate(
        [np.full(b - a, a, np.uint32) for a, b in zip(offs[:-1], offs[1:])])
    np.testing.assert_array_equal(np.asarray(ranks), rv - starts)


def test_segments_masked_descending_xla(rng):
    n = 1500
    offs = _offsets(rng, n, 9)
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    # composite packing: ~11 segments need 4 bits; 4 + 16 <= 32
    np.testing.assert_array_equal(
        np.asarray(trs.sort_segments(jnp.asarray(k), jnp.asarray(offs),
                                     bit_count=16)),
        _ref(k, offs, bit_count=16))
    np.testing.assert_array_equal(
        np.asarray(trs.sort_segments(jnp.asarray(k), jnp.asarray(offs),
                                     descending=True)),
        _ref(k, offs, descending=True))
    # separate segment column: 4 + 32 > 32 (unmasked)
    np.testing.assert_array_equal(
        np.asarray(trs.sort_segments(jnp.asarray(k), jnp.asarray(offs))),
        _ref(k, offs))
    for kwargs in ({}, {"bit_count": 12, "descending": True}):
        a = trs.sort_segments(jnp.asarray(k), jnp.asarray(offs),
                              method="auto", **kwargs)
        b = trs.sort_segments(jnp.asarray(k), jnp.asarray(offs),
                              method="xla", **kwargs)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a), _ref(k, offs, **kwargs))


def test_segments_traced_offsets_share_pipeline(rng):
    """offsets are a traced operand: two segmentations of the same shape
    must both be byte-exact through one jitted pipeline."""
    n = 1024
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    for cuts in (5, 5):  # same offsets SHAPE, different values
        offs = _offsets(rng, n, cuts, with_empty=False)
        np.testing.assert_array_equal(
            np.asarray(trs.sort_segments(jnp.asarray(k), jnp.asarray(offs))),
            _ref(k, offs))


def test_segments_validation():
    k = jnp.zeros(16, jnp.uint32)
    with pytest.raises(ValueError):
        trs.sort_segments(jnp.zeros((2, 8), jnp.uint32), jnp.zeros(2, jnp.int32))
    with pytest.raises(ValueError):
        trs.sort_segments(k, jnp.zeros(1, jnp.int32))
    with pytest.raises(TypeError):
        trs.sort_segments(k, jnp.zeros(3, jnp.float32))
    with pytest.raises(ValueError):
        trs.sort_segments(k, jnp.asarray([0, 16]), method="radix")
