"""Runtime layer: native CPU baseline sorter + bindings, host-clock timer."""
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_radix_sort.runtime import Timing, time_call
from tpu_radix_sort.runtime.cpu_baseline import (
    cpu_disorder_count,
    cpu_sort,
    native_available,
)


def test_native_cpu_sort_matches_numpy(rng):
    k = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    v = np.arange(k.size, dtype=np.uint32)
    sk, sv = cpu_sort(k, v)
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(sk, k[order])
    np.testing.assert_array_equal(sv, v[order])
    np.testing.assert_array_equal(cpu_sort(k), k[order])


def test_native_disorder_count(rng):
    k = rng.integers(0, 2**16, 10_000, dtype=np.uint64).astype(np.uint32)
    expect = int(np.sum(k[:-1] > k[1:]))
    assert cpu_disorder_count(k) == expect
    assert cpu_disorder_count(np.sort(k)) == 0
    assert cpu_disorder_count(np.array([7], dtype=np.uint32)) == 0


def test_native_build_available():
    # g++ is baked into this image; the binding must actually build.
    assert native_available()


class _FakeClock:
    """Returns the given instants in order, one per call."""

    def __init__(self, instants):
        self._it = iter(instants)

    def __call__(self):
        return next(self._it)


def test_time_call_fake_clock():
    """Each sample is the clock difference around one blocked call; warm-up
    calls are not timed (they read no clock)."""
    calls = []

    def fn(x):
        calls.append(x)
        return jnp.asarray(x)

    clock = _FakeClock([0.0, 1.0, 10.0, 13.0, 20.0, 22.0])
    t = time_call(fn, 5, warmup=2, reps=3, clock=clock)
    assert t.samples == (1.0, 3.0, 2.0)
    assert len(calls) == 5
    assert t.median == 2.0 and t.min == 1.0 and t.max == 3.0
    assert t.quartiles == (1.5, 2.5)


def test_timing_summary_and_validation():
    t = Timing((0.002, 0.001, 0.004, 0.003))
    assert t.median == 0.0025
    assert "median=2.5000ms" in t.summary_ms() and "n=4" in t.summary_ms()
    assert Timing((0.5,)).quartiles == (0.5, 0.5)
    with pytest.raises(ValueError):
        time_call(lambda: None, reps=0)


def test_time_call_smoke():
    """A real (tiny) op on the CPU: ten positive, finite samples."""
    x = jnp.arange(1024, dtype=jnp.uint32)
    t = time_call(lambda a: a + jnp.uint32(1), x)
    assert len(t.samples) == 10
    assert all(np.isfinite(s) and s > 0 for s in t.samples)
