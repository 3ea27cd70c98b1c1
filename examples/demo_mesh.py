"""Distributed-sort demo over a JAX device mesh.

The reference has no multi-device story (browser, one GPUDevice); this
demo drives the new-subsystem layer (SURVEY.md §2.4/§7): both exchange
strategies over a `jax.sharding.Mesh` axis, verified against the golden
model, on a mesh of virtual CPU devices (the path `tests/` validates).
`chip_smoke.py --mesh4` runs the same sorts on four GPUs.

Usage:
    python examples/demo_mesh.py --devices 8 --n 100000 --values
    python examples/demo_mesh.py --devices 4 --strategy exchange --skew
    python examples/demo_mesh.py --devices 8 --strategy mesh --overlap 4
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# request virtual CPU devices before jax initializes
_n_req = 8
for _i, _a in enumerate(sys.argv):
    if _a == "--devices" and _i + 1 < len(sys.argv):
        _n_req = int(sys.argv[_i + 1])
    elif _a.startswith("--devices="):  # argparse also accepts this form
        _n_req = int(_a.split("=", 1)[1])
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={_n_req}"
    )

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import tpu_radix_sort as trs
from tpu_radix_sort.models.golden import golden_sort
from tpu_radix_sort.parallel import sharded
from tpu_radix_sort.runtime import device as dev


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--devices", type=int, default=8,
                   help="mesh size (virtual CPU devices here; chips on real hardware)")
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--values", action="store_true", help="key+value records")
    p.add_argument("--strategy", default="both",
                   choices=["mesh", "exchange", "both"],
                   help="mesh = bitonic compare-split network; "
                        "exchange = exact-splitter single ragged all-to-all")
    p.add_argument("--skew", action="store_true",
                   help="Zipf(1.3)-skewed keys (rank splitting stays balanced)")
    p.add_argument("--overlap", type=int, default=1,
                   help="mesh strategy: exchange pipelined in this many "
                        "sub-chunks (comm/compute overlap)")
    p.add_argument("--descending", action="store_true")
    p.add_argument("--scan", action="store_true",
                   help="also run the distributed prefix sum + order checks "
                        "(prefix_sum/is_sorted/disorder_count with mesh=)")
    p.add_argument("--dtype", default="uint32",
                   choices=["uint32", "uint64"],
                   help="key dtype; uint64 runs (hi, lo, idx) column "
                        "tuples through either strategy (the exchange "
                        "splitter bisects the joined u64 domain)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    dev.enable_compile_cache()
    wide = args.dtype == "uint64"
    if wide:
        jax.config.update("jax_enable_x64", True)

    cpus = jax.devices("cpu")
    if len(cpus) < args.devices:
        p.error(f"only {len(cpus)} CPU devices (run with --devices <= that, "
                f"or set XLA_FLAGS=--xla_force_host_platform_device_count)")
    mesh = Mesh(np.array(cpus[: args.devices]), ("x",))
    print(f"mesh: {args.devices} x {cpus[0].platform}")

    rng = np.random.default_rng(args.seed)
    if args.skew:
        keys_np = rng.zipf(1.3, size=args.n).astype(
            np.uint64 if wide else np.uint32)
    elif wide:
        keys_np = rng.integers(0, 2**64, args.n, dtype=np.uint64)
    else:
        keys_np = rng.integers(0, 2**32, args.n, dtype=np.uint64).astype(np.uint32)
    values_np = np.arange(args.n, dtype=np.uint32) if args.values else None

    keys = sharded(mesh, "x", jnp.asarray(keys_np))
    values = sharded(mesh, "x", jnp.asarray(values_np)) if args.values else None

    strategies = []
    if args.strategy in ("mesh", "both"):
        strategies.append(("mesh_sort (compare-split)", lambda k, v: trs.mesh_sort(
            k, v, mesh=mesh, descending=args.descending,
            overlap_chunks=args.overlap)))
    if args.strategy in ("exchange", "both"):
        strategies.append(("exchange_sort (exact splitters)",
                           lambda k, v: trs.exchange_sort(
                               k, v, mesh=mesh, descending=args.descending)))

    if args.values:
        ref_k, ref_v = golden_sort(keys_np, values_np, descending=args.descending)
    else:
        ref_k = golden_sort(keys_np, descending=args.descending)

    for name, fn in strategies:
        t0 = time.time()
        if args.values:
            out_k, out_v = fn(keys, values)
            ok = (np.array_equal(np.asarray(out_k), ref_k)
                  and np.array_equal(np.asarray(out_v), ref_v))
        else:
            out_k = fn(keys, None)
            ok = np.array_equal(np.asarray(out_k), ref_k)
        print(f"  {name:34s} {time.time()-t0:6.1f}s  golden-exact={ok}")

    if args.scan:
        from tpu_radix_sort.models.golden import golden_prefix_sum

        small = keys_np % np.uint32(100)
        xs = sharded(mesh, "x", jnp.asarray(small))
        t0 = time.time()
        ps_ok = np.array_equal(
            np.asarray(trs.prefix_sum(xs, mesh=mesh)),
            golden_prefix_sum(small),
        )
        print(f"  {'prefix_sum (mesh)':34s} {time.time()-t0:6.1f}s  "
              f"golden-exact={ps_ok}")
        t0 = time.time()
        dis = int(trs.disorder_count(keys, mesh=mesh))
        srt_ok = bool(trs.is_sorted(
            sharded(mesh, "x", jnp.asarray(np.sort(keys_np))), mesh=mesh))
        print(f"  {'order checks (mesh)':34s} {time.time()-t0:6.1f}s  "
              f"disorder={dis}  sorted-input-is_sorted={srt_ok}")


if __name__ == "__main__":
    main()
