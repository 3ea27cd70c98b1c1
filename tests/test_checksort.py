"""Order-check reduction (reference: CheckSort kernel family)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_radix_sort as trs
from tpu_radix_sort.models.golden import golden_is_sorted
from tpu_radix_sort.ops import checksort


def test_disorder_count(rng):
    u = jnp.asarray(np.array([1, 2, 2, 1, 5, 4], dtype=np.uint32))
    assert int(checksort.disorder_count(u)) == 2
    assert int(checksort.disorder_count(jnp.asarray(np.array([7], dtype=np.uint32)))) == 0


def test_is_sorted_small(rng):
    assert bool(checksort.is_sorted(jnp.arange(10, dtype=jnp.uint32)))
    assert not bool(checksort.is_sorted(jnp.asarray(np.array([2, 1], dtype=np.uint32))))


def test_is_sorted_fast_gate(rng):
    # disorder past the fast window must still be detected by the full check
    n = checksort.FAST_CHECK_ELEMENTS * 4
    a = np.arange(n, dtype=np.uint32)
    assert bool(checksort.is_sorted(jnp.asarray(a)))
    a[n - 2], a[n - 1] = a[n - 1], a[n - 2]
    assert not bool(checksort.is_sorted(jnp.asarray(a)))
    # disorder exactly at the fast/full boundary (the reference overlaps the
    # boundary pair by starting the full check one element early)
    b = np.arange(n, dtype=np.uint32)
    f = checksort.FAST_CHECK_ELEMENTS
    b[f - 1], b[f] = b[f], b[f - 1]
    assert not bool(checksort.is_sorted(jnp.asarray(b)))


def test_public_is_sorted_jits():
    f = jax.jit(lambda x: trs.is_sorted(x))
    assert bool(f(jnp.arange(100, dtype=jnp.uint32)))


def test_subrange_checks_vs_golden(rng):
    """count / bit_count overrides mirror the reference check kernels'
    START_ELEMENT/ELEMENT_COUNT slice checks (CheckSortBufferKernel.ts:84-103);
    golden_is_sorted is the oracle."""
    n = 5000
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    u[:3000] = np.sort(u[:3000])
    uj = jnp.asarray(u)
    for count in (0, 1, 100, 2999, 3000, 3001, n):
        got = bool(trs.is_sorted(uj, count=count))
        assert got == golden_is_sorted(u, count=count), count
    # bit_count: sorted on the low bits but not the full key
    lo = np.sort(rng.integers(0, 256, n, dtype=np.uint64).astype(np.uint32))
    k = lo | (rng.integers(0, 2**24, n, dtype=np.uint64).astype(np.uint32) << 8)
    assert bool(trs.is_sorted(jnp.asarray(k), bit_count=8))
    assert bool(trs.is_sorted(jnp.asarray(k), bit_count=8)) == golden_is_sorted(k, bit_count=8)
    assert bool(trs.is_sorted(jnp.asarray(k))) == golden_is_sorted(k)
    # disorder_count with count: inversions only inside the prefix
    d = np.array([1, 5, 2, 9, 0], dtype=np.uint32)
    assert int(trs.disorder_count(jnp.asarray(d), count=2)) == 0
    assert int(trs.disorder_count(jnp.asarray(d), count=3)) == 1
    assert int(trs.disorder_count(jnp.asarray(d), count=5)) == 2
    # float32 keys are checked by bit pattern like the sort
    f = np.sort(rng.random(100).astype(np.float32))
    assert bool(trs.is_sorted(jnp.asarray(f)))
    with pytest.raises(ValueError):
        trs.is_sorted(uj, count=n + 1)
    with pytest.raises(ValueError):
        trs.disorder_count(uj, bit_count=7)


LARGE = 2048 * 128


def test_disorder_count_large(rng):
    """Large inputs, exact counts vs NumPy."""
    for blocks in (1, 2):
        n = LARGE * blocks
        u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        expect = int(np.sum(u[:-1] > u[1:]))
        assert int(checksort.disorder_count(jnp.asarray(u))) == expect
        assert int(checksort.disorder_count(jnp.asarray(np.sort(u)))) == 0


def test_disorder_count_arbitrary_n(rng):
    """Lengths off every power of two; max-valued keys at the tail."""
    base = LARGE
    for n in (base + 1, base + 4096, base + base // 2):
        u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        expect = int(np.sum(u[:-1] > u[1:]))
        assert int(checksort.disorder_count(jnp.asarray(u))) == expect, n
        s = np.sort(u)
        assert int(checksort.disorder_count(jnp.asarray(s))) == 0, n
        # max-valued real elements at the tail
        s[-5:] = 0xFFFFFFFF
        assert int(checksort.disorder_count(jnp.asarray(s))) == 0, n
        assert bool(checksort.is_sorted(jnp.asarray(s))), n


def test_check_flags_verify_sort_output(rng):
    """The check ops can verify every option surface the sort produces
   : `total_order=` / `descending=` output must
    read as sorted under the same flags — the check compares the same key
    view the sort ordered by (`src/shaders/CheckSort.ts:102-113` lifted to
    the full option surface)."""
    n = 4096
    # negatives included: raw bit-pattern order != total order for these
    f = rng.standard_normal(n).astype(np.float32)
    s_to = trs.sort(jnp.asarray(f), total_order=True)
    assert bool(trs.is_sorted(s_to, total_order=True))
    assert int(trs.disorder_count(s_to, total_order=True)) == 0
    # the raw-bit-pattern view of totally-ordered negative floats is NOT
    # sorted (sign bit set => huge bit patterns up front)
    assert not bool(trs.is_sorted(s_to))
    assert golden_is_sorted(np.asarray(s_to), total_order=True)
    assert not golden_is_sorted(np.asarray(s_to))

    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    s_d = trs.sort(jnp.asarray(k), descending=True)
    assert bool(trs.is_sorted(s_d, descending=True))
    assert int(trs.disorder_count(s_d, descending=True)) == 0
    assert not bool(trs.is_sorted(s_d))
    assert golden_is_sorted(np.asarray(s_d), descending=True)

    # combined with masking: total-order int32, descending on the low 8 bits
    i = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    s_td = trs.sort(jnp.asarray(i), total_order=True, descending=True,
                    bit_count=8)
    assert bool(trs.is_sorted(s_td, total_order=True, descending=True,
                              bit_count=8))
    assert golden_is_sorted(np.asarray(s_td), total_order=True,
                            descending=True, bit_count=8)

    # direction is really flipped: ascending iota is maximally descending-
    # unsorted, and vice versa
    a = jnp.arange(100, dtype=jnp.uint32)
    assert int(trs.disorder_count(a, descending=True)) == 99
    assert int(trs.disorder_count(a[::-1], descending=True)) == 0

    # count composes with the flags: only the prefix is checked
    d = np.array([9, 5, 5, 7, 0], dtype=np.uint32)
    assert bool(trs.is_sorted(jnp.asarray(d), count=3, descending=True))
    assert not bool(trs.is_sorted(jnp.asarray(d), count=4, descending=True))


def test_check_flags_large(rng):
    """Flagged checks at a large, non-power-of-two size."""
    n = LARGE + 4096
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    s = np.sort(k)[::-1].copy()
    assert bool(trs.is_sorted(jnp.asarray(s), descending=True))
    assert not bool(trs.is_sorted(jnp.asarray(s)))
    f = np.sort(rng.standard_normal(n).astype(np.float32))
    assert bool(trs.is_sorted(jnp.asarray(f), total_order=True))
    assert int(trs.disorder_count(jnp.asarray(f[::-1].copy()),
                                  total_order=True, descending=True)) == 0
