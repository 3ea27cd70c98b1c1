"""Distributed batched (per-row) sorts over a `jax.sharding.Mesh` axis.

Rows are independent, so the mesh lift of `ops/batched.py` is the one
genuinely collective-free case in the parallel layer: shard the batch
dimension, sort each shard's rows, done — zero exchange bytes. The
shard_map states that partitioning outright, so no exchange can appear.

Batch counts that don't divide the device count pad with dummy rows
(sorted wastefully on the last shard, sliced off — rows never interact).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import batched as ops_batched, common


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis_name", "bit_count", "descending",
                     "total_order"),
)
def mesh_sort_batched(
    keys,
    values=None,
    *,
    mesh: Mesh,
    axis_name: str = "x",
    bit_count: int,
    descending: bool = False,
    total_order: bool = False,
):
    """Distributed core of `sort_batched(mesh=)`. Callers (the public
    wrapper in `ops/batched.py`) have already validated dtypes/shapes and
    resolved `bit_count`; semantics match the single-chip
    `_sort_batched_jit` row for row."""
    n_dev = mesh.shape[axis_name]
    B, n = keys.shape
    B_pad = common.round_up(max(B, 1), n_dev)
    if B_pad != B:
        keys = jnp.pad(keys, ((0, B_pad - B), (0, 0)))
        if values is not None:
            values = jnp.pad(values, ((0, B_pad - B), (0, 0)))

    core = functools.partial(
        ops_batched._sort_batched_jit,
        bit_count=bit_count,
        descending=descending,
        total_order=total_order,
    )
    if values is None:
        fn = jax.shard_map(
            lambda k: core(k, None),
            mesh=mesh, in_specs=P(axis_name, None),
            out_specs=P(axis_name, None), check_vma=False,
        )
        out = fn(keys)
        return out[:B]
    fn = jax.shard_map(
        lambda k, v: core(k, v),
        mesh=mesh, in_specs=(P(axis_name, None), P(axis_name, None)),
        out_specs=(P(axis_name, None), P(axis_name, None)), check_vma=False,
    )
    out_k, out_v = fn(keys, values)
    return out_k[:B], out_v[:B]
