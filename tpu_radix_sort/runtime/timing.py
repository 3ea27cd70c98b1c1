"""Host-clock timing of device work (reference counterpart: GPU timestamp
queries, `example/tests.ts:247-285`).

JAX dispatch is asynchronous, so each sample is the host clock around one
call that ends in `jax.block_until_ready`: the call's full device time plus
its dispatch. Warm-up calls run first (they compile and fill caches), then
`reps` samples are summarised as a median with its spread.
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import jax


@dataclasses.dataclass(frozen=True)
class Timing:
    """Seconds per call over the timed samples, in the order taken."""

    samples: tuple[float, ...]

    @property
    def median(self) -> float:
        return statistics.median(self.samples)

    @property
    def quartiles(self) -> tuple[float, float]:
        """(25th, 75th) percentile; the spread reported beside the median."""
        if len(self.samples) < 2:
            return self.samples[0], self.samples[0]
        q = statistics.quantiles(self.samples, n=4, method="inclusive")
        return q[0], q[2]

    @property
    def min(self) -> float:
        return min(self.samples)

    @property
    def max(self) -> float:
        return max(self.samples)

    def summary_ms(self) -> str:
        q1, q3 = self.quartiles
        return (f"median={self.median * 1e3:.4f}ms "
                f"iqr=[{q1 * 1e3:.4f},{q3 * 1e3:.4f}]ms "
                f"range=[{self.min * 1e3:.4f},{self.max * 1e3:.4f}]ms "
                f"n={len(self.samples)}")


def time_call(fn, *args, warmup: int = 2, reps: int = 10,
              clock=time.perf_counter) -> Timing:
    """Time `fn(*args)`: `warmup` untimed calls, then `reps` timed ones.

    Every call, warm-up included, waits for its result with
    `jax.block_until_ready`, so no sample overlaps the previous call's
    device work. `clock` is injectable for tests.
    """
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(reps):
        t0 = clock()
        jax.block_until_ready(fn(*args))
        samples.append(clock() - t0)
    return Timing(tuple(samples))
