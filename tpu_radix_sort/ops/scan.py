"""Exclusive prefix scan (public op).

Reference counterpart: `PrefixSumKernel` — a recursive Blelloch scan that
dispatches one reduce/downsweep pipeline per level plus add-back passes
(`src/kernels/PrefixSumKernel.ts:45-133`, `src/shaders/PrefixSum.ts`). Here
a CUDA lowering runs the two-kernel reduce-then-scan of `ops/scan_triton.py`
(Pallas on the Triton route), which measured faster than XLA's `cumsum` on
an H100; every other platform runs `jnp.cumsum` in u32. Both wrap exactly
like the reference's u32 adds.

Semantics match the reference: exclusive scan, u32 wraparound addition, in
place over the first `count` elements, the rest untouched
(`example/tests.ts:288-296` oracle).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import common, scan_triton


def prefix_sum(items, *, count=None, inclusive=False, mesh=None,
               axis_name="x"):
    """Exclusive (default) prefix sum of the first `count` elements, u32 wrap.

    Matches the reference's public PrefixSumKernel semantics: ascending
    exclusive scan, in place over the prefix, suffix untouched.

    ``mesh=`` runs the scan across a `jax.sharding.Mesh` axis (shard `items`
    along `axis_name`): per-shard scan + ONE tiny all_gather of shard
    totals (`parallel/scan.py`).
    """
    if mesh is not None:
        from ..parallel.scan import mesh_prefix_sum

        return mesh_prefix_sum(
            items, mesh=mesh, axis_name=axis_name, count=count,
            inclusive=inclusive,
        )
    items = jnp.asarray(items)
    if items.dtype not in (jnp.uint32, jnp.int32):
        raise TypeError(f"prefix_sum expects uint32/int32, got {items.dtype}")
    if items.ndim != 1:
        raise ValueError("items must be 1-D")
    n = items.shape[0]
    count = n if count is None else int(count)
    if not (0 <= count <= n):
        raise ValueError(f"count {count} out of range")
    if count == 0:
        return items
    return _prefix_sum_jit(items, count=count, inclusive=inclusive)


def scan_xla(u, *, inclusive):
    """u32 prefix sum through XLA's cumsum."""
    inc = jnp.cumsum(u, dtype=jnp.uint32)
    return inc if inclusive else inc - u


def scan_gpu(u, *, inclusive, interpret=False):
    """u32 prefix sum through the Triton kernels, zero-padded to whole
    CHUNKs (zeros do not change a sum scan). `interpret` runs the kernels
    in the Pallas interpreter (tests on the CPU)."""
    n = u.shape[0]
    padded = common.pad_to(u, common.round_up(n, scan_triton.CHUNK),
                           jnp.uint32(0))
    return scan_triton.scan_u32(padded, inclusive=inclusive,
                                interpret=interpret)[:n]


@functools.partial(jax.jit, static_argnames=("count", "inclusive"))
def _prefix_sum_jit(items, *, count, inclusive):
    n = items.shape[0]
    u = jax.lax.bitcast_convert_type(items[:count], jnp.uint32)
    out = jax.lax.platform_dependent(
        u,
        default=functools.partial(scan_xla, inclusive=inclusive),
        cuda=functools.partial(scan_gpu, inclusive=inclusive),
    )
    out = jax.lax.bitcast_convert_type(out, items.dtype)
    if count == n:
        return out
    return jnp.concatenate([out, items[count:]])
