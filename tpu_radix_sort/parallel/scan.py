"""Distributed prefix sum over a `jax.sharding.Mesh` axis.

The reference's public `PrefixSumKernel` (`src/kernels/PrefixSumKernel.ts`)
is single-GPU; this lifts the op to the mesh layer the same way the sorts
are lifted (SURVEY.md §2.4 cross-device subsystem). The reference's
recursion-until-one-workgroup shape (`PrefixSumKernel.ts:111-113`) maps to
exactly ONE collective level here: each shard scans its local chunk with
`jnp.cumsum`, shard totals are all-gathered once, and every shard adds the closed-form prefix of the
totals before it — u32 wraparound addition is associative, so the offset
fold is exact.

Communication: one (1,)-per-shard `all_gather` — no data exchange at all
(a scan never moves elements).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import common


def _shard_prefix_sum(items, *, axis_name, n_dev, count, inclusive):
    """Per-shard body. items: (L,) u32 local chunk of the zero-padded
    global array. `count` is the GLOBAL count; elements at global index
    >= count pass through untouched (the reference's in-place-over-prefix
    contract) and contribute zero to the scan."""
    L = items.shape[0]
    me = jax.lax.axis_index(axis_name)
    gidx = me.astype(jnp.uint32) * jnp.uint32(L) + jnp.arange(L, dtype=jnp.uint32)
    active = gidx < jnp.uint32(count)
    u = jnp.where(active, items, jnp.uint32(0))

    inc = jnp.cumsum(u, dtype=jnp.uint32)
    total = inc[L - 1]

    # one collective: exclusive prefix of the shard totals
    totals = jax.lax.all_gather(total[None], axis_name).reshape(n_dev)
    before = (jnp.arange(n_dev, dtype=jnp.int32) < me).astype(jnp.uint32)
    offset = jnp.sum(totals * before, dtype=jnp.uint32)

    scanned = (inc if inclusive else inc - u) + offset
    return jnp.where(active, scanned, items)


def mesh_prefix_sum(items, *, mesh: Mesh, axis_name: str = "x", count=None,
                    inclusive: bool = False):
    """Prefix sum of the first `count` elements across a mesh axis.

    Semantics match the single-chip :func:`tpu_radix_sort.prefix_sum`
    (exclusive by default, u32 wraparound, suffix untouched). Shard `items`
    along `axis_name`; the one collective is a tiny all_gather.
    """
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
    return _mesh_prefix_sum_core(items, mesh=mesh, axis_name=axis_name,
                                 count=count, inclusive=inclusive)


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis_name", "count", "inclusive"))
def _mesh_prefix_sum_core(items, *, mesh, axis_name, count, inclusive):
    n = items.shape[0]
    n_dev = mesh.shape[axis_name]
    u = jax.lax.bitcast_convert_type(items, jnp.uint32)
    n_pad = common.round_up(n, n_dev)
    # zero pad: padded tail is beyond count, passes through, sliced off
    u = common.pad_to(u, n_pad, jnp.uint32(0))

    fn = jax.shard_map(
        functools.partial(
            _shard_prefix_sum,
            axis_name=axis_name,
            n_dev=n_dev,
            count=count,
            inclusive=inclusive,
        ),
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(axis_name),
        check_vma=False,
    )
    out = fn(u)[:n]
    return jax.lax.bitcast_convert_type(out, items.dtype)
