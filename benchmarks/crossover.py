"""GPU-vs-CPU crossover: where does the card beat the host?

The reference's headline qualitative claim is "the GPU sort beats the CPU
above ~100,000 elements" (`/root/reference/README.md:16`), measured against
the host's `Array.prototype.sort` (`example/index.ts:147-151`). This is that
experiment here: `trs.sort` on the GPU vs the native C++ LSD radix sorter
(`runtime/native/sort.cc`, the strongest host baseline in the repo — it
beats NumPy's stable sort several-fold) across element-count decades.

GPU times are host-clock medians around calls that end in
`block_until_ready` (`runtime.time_call`); "1-shot" adds the host-to-device
copy of the input and the fetch of the result. CPU times are plain
perf_counter medians.

Run on the GPU: python benchmarks/crossover.py
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tpu_radix_sort as trs  # noqa: E402
from tpu_radix_sort.runtime import device as dev  # noqa: E402
from tpu_radix_sort.runtime import time_call  # noqa: E402
from tpu_radix_sort.runtime.cpu_baseline import cpu_sort, native_available  # noqa: E402


def cpu_time(fn, reps=5):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    dev.require_gpu()
    dev.enable_compile_cache()
    print(f"device: {jax.devices()[0].device_kind}; {dev.card_lines()[0]}")
    rng = np.random.default_rng(7)
    print(f"native CPU baseline available: {native_available()}")
    print(f"{'n':>10} | {'GPU keys':>10} {'1-shot':>10} {'CPU keys':>10} "
          f"{'win':>6} | {'GPU k+v':>10} {'CPU k+v':>10} {'win':>6}")
    f_k = jax.jit(lambda a: trs.sort(a))
    f_kv = jax.jit(lambda a, b: trs.sort(a, b))
    for e in range(10, 25, 2):
        n = 1 << e
        keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        vals = np.arange(n, dtype=np.uint32)
        kj, vj = jnp.asarray(keys), jnp.asarray(vals)

        t_gpu_k = time_call(f_k, kj).median
        t_one_k = cpu_time(lambda: np.asarray(f_k(jnp.asarray(keys))))
        t_gpu_kv = time_call(f_kv, kj, vj).median
        t_cpu_k = cpu_time(lambda: cpu_sort(keys))
        t_cpu_kv = cpu_time(lambda: cpu_sort(keys, vals))

        def fmt(t):
            return f"{t*1e6:9.1f}u" if t < 1e-3 else f"{t*1e3:9.2f}m"

        print(f"2^{e:<8} | {fmt(t_gpu_k)} {fmt(t_one_k)} {fmt(t_cpu_k)} "
              f"{t_cpu_k / t_gpu_k:5.1f}x | {fmt(t_gpu_kv)} {fmt(t_cpu_kv)} "
              f"{t_cpu_kv / t_gpu_kv:5.1f}x")


if __name__ == "__main__":
    main()
