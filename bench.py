"""Headline benchmark: 2^26 uint32 key+value sort throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.

value        = sorted keys/s of `trs.sort` at N = 2^26 uint32 key + uint32
               value (BASELINE.json config 2 at the reference's
               maxBufferSize ceiling): N over the median host-clock time of
               one call ending in `block_until_ready`.
vs_baseline  = speedup vs `jax.lax.sort` (XLA's stock stable sort) on the
               same card and workload (the reference itself publishes no
               numbers, BASELINE.md).
device       = the card as JAX reports it, plus its power limit from
               nvidia-smi (a card below 700 W runs slower under load).

Refuses to run anywhere but a GPU. Usage: python bench.py [N]
"""
import json
import sys


def run(n, reps=20):
    import jax
    import jax.numpy as jnp

    import tpu_radix_sort as trs
    from tpu_radix_sort.runtime import device as dev
    from tpu_radix_sort.runtime import time_call

    dev.require_gpu()
    dev.enable_compile_cache()
    d0 = jax.devices()[0]
    _, power_limit = dev.parse_nvidia_smi(dev.card_lines()[0])[0]

    keys = jax.random.bits(jax.random.PRNGKey(0), (n,), dtype=jnp.uint32)
    values = jnp.arange(n, dtype=jnp.uint32)
    ours = jax.jit(lambda k, v: trs.sort(k, v))
    xla = jax.jit(lambda k, v: jax.lax.sort((k, v), num_keys=1,
                                            is_stable=True))
    t_ours = time_call(ours, keys, values, reps=reps).median
    t_xla = time_call(xla, keys, values, reps=reps).median
    return {
        "metric": f"sort throughput, {n} uint32 key+value, 1 chip",
        "value": n / t_ours,
        "unit": "keys/s",
        "vs_baseline": t_xla / t_ours,
        "device": {"platform": d0.platform, "kind": d0.device_kind,
                   "count": len(jax.devices()),
                   "power_limit": power_limit},
    }


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else (1 << 26)
    print(json.dumps(run(n)))


if __name__ == "__main__":
    main()
