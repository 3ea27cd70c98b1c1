"""Golden-model self-consistency: the oracle must itself match the reference
semantics (stable ascending by masked bit pattern, prefix-only, suffix
untouched — SURVEY.md section 4)."""
import numpy as np
import pytest

from tpu_radix_sort.models.golden import golden_is_sorted, golden_prefix_sum, golden_sort


def test_sorts_ascending_stable(rng):
    k = rng.integers(0, 50, 1000).astype(np.uint32)
    v = np.arange(1000, dtype=np.uint32)
    ks, vs = golden_sort(k, v)
    assert np.array_equal(ks, np.sort(k, kind="stable"))
    # stability: equal keys keep original order -> values increasing per group
    for key in np.unique(k):
        grp = vs[ks == key]
        assert np.all(np.diff(grp.astype(np.int64)) > 0)
    # payload is the same permutation
    assert np.array_equal(k[vs], ks)


def test_subcount_leaves_suffix(rng):
    k = rng.integers(0, 2**32, 100, dtype=np.uint64).astype(np.uint32)
    out = golden_sort(k, count=60)
    assert np.array_equal(out[:60], np.sort(k[:60]))
    assert np.array_equal(out[60:], k[60:])


def test_bit_count_masks_high_bits():
    k = np.array([0x30, 0x21, 0x12, 0x03], dtype=np.uint32)
    # bit_count=4: order by low nibble only, stable
    out = golden_sort(k, bit_count=4)
    assert np.array_equal(out, np.array([0x30, 0x21, 0x12, 0x03], dtype=np.uint32))
    out = golden_sort(k, bit_count=8)
    assert np.array_equal(out, np.sort(k))


def test_float32_bit_pattern_order(rng):
    k = (rng.random(512) * 1000).astype(np.float32)  # non-negative
    out = golden_sort(k)
    assert np.array_equal(out, np.sort(k))


def test_bit_count_validation():
    k = np.zeros(4, dtype=np.uint32)
    for bad in (0, 3, 5, 33, 2):
        with pytest.raises(ValueError):
            golden_sort(k, bit_count=bad)


def test_prefix_sum_exclusive_wraps():
    x = np.array([1, 2, 3, 0xFFFFFFFF, 5], dtype=np.uint32)
    out = golden_prefix_sum(x)
    assert out[0] == 0 and out[1] == 1 and out[2] == 3 and out[3] == 6
    assert out[4] == np.uint32((6 + 0xFFFFFFFF) & 0xFFFFFFFF)


def test_is_sorted():
    assert golden_is_sorted(np.array([1, 2, 2, 3], dtype=np.uint32))
    assert not golden_is_sorted(np.array([1, 3, 2], dtype=np.uint32))
    # masked order check
    assert golden_is_sorted(np.array([0x12, 0x03], dtype=np.uint32), bit_count=4)


def test_prefix_sum_exact_past_2_pow_53():
    """Running sums past 2^53 (where a float64 intermediate drops low bits)
    stay exact mod 2^32."""
    x = np.full(1 << 23, 0xFFFFFFFF, dtype=np.uint32)  # total ~ 2^55
    x[::3] = 0x7FFFFFFB
    out = golden_prefix_sum(x)
    sums = np.cumsum(x.astype(object))  # Python integers: exact
    for i in (1, 2, 3, (1 << 22) + 7, x.size - 1):
        assert int(out[i]) == int(sums[i - 1]) % (1 << 32), i


@pytest.mark.parametrize("dtype", ["int64", "float64", "float32", "int32",
                                   "float16"])
def test_total_order_matches_numeric_sort(rng, dtype):
    k = (rng.standard_normal(2000) * 100).astype(dtype)
    k[:300] = k[0]  # equal run: stability
    v = np.arange(k.size, dtype=np.uint32)
    rk, rv = golden_sort(k, v, total_order=True)
    order = np.argsort(k, kind="stable")
    assert np.array_equal(rk, k[order]) and np.array_equal(rv, v[order])
    rkd, rvd = golden_sort(k, v, total_order=True, descending=True)
    order_d = np.argsort(-k.astype(np.float64), kind="stable")
    assert np.array_equal(rkd, k[order_d]) and np.array_equal(rvd, v[order_d])
