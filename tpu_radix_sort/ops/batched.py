"""Batched (per-row) sorts: independently sort each row of a 2-D array.

Extension past the reference (one flat buffer per sort,
``src/kernels/radix-sort/AbstractRadixSortKernel.ts``). The engine is
`jax.lax.sort` along the last axis, which sorts every row independently
with no row-id column.

Stability per row, `descending`, `total_order`, masked `bit_count`, value
payloads, and every key dtype (incl. 64-bit under jax x64) carry over from
the flat sort.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import common
from .sort import validate_method


def sort_batched(
    keys,
    values=None,
    *,
    bit_count: int | None = None,
    descending: bool = False,
    total_order: bool = False,
    method: str = "auto",
    mesh=None,
    axis_name: str = "x",
):
    """Sort each row of a (B, n) key array independently (stable, ascending
    by default), co-permuting an optional same-shape 4- or 8-byte `values`
    array.

    Same key-dtype surface as :func:`sort` (uint32/float32/int32, the
    16-bit dtypes, and the 64-bit dtypes under jax x64); `bit_count` masks
    per key word like the flat sort. Returns keys or (keys, values), same
    shape.

    ``mesh=`` shards the BATCH dimension across the mesh axis — rows are
    independent, so this is the collective-free case of the parallel
    layer (`parallel/batched.py`); shard inputs `P(axis_name, None)`.
    """
    common.guard_64bit_downcast(keys)
    keys = jnp.asarray(keys)
    if keys.ndim != 2:
        raise ValueError("sort_batched expects a 2-D (batch, n) key array")
    wide = common.is_64bit_key_dtype(keys.dtype)
    if wide:
        bit_count = 64 if bit_count is None else bit_count
        common.validate_bit_count_64(bit_count)
    elif (keys.dtype in (jnp.uint32, jnp.float32, jnp.int32)
          or common.is_16bit_key_dtype(keys.dtype)):
        if bit_count is None:
            bit_count = common.native_key_bits(keys.dtype)
        common.validate_bit_count_for(keys.dtype, bit_count)
    else:
        raise TypeError(f"unsupported key dtype {keys.dtype}")
    if values is not None:
        common.guard_64bit_value_downcast(values)
        values = jnp.asarray(values)
        if values.shape != keys.shape:
            raise ValueError("values must match keys shape")
        common.validate_value_dtype(values)
    validate_method(method)
    if mesh is not None:
        from ..parallel.batched import mesh_sort_batched

        return mesh_sort_batched(
            keys, values,
            mesh=mesh, axis_name=axis_name, bit_count=bit_count,
            descending=descending, total_order=total_order,
        )
    return _sort_batched_jit(
        keys,
        values,
        bit_count=bit_count,
        descending=descending,
        total_order=total_order,
    )


def argsort_batched(keys, **kwargs):
    """Per-row stable argsort: the original column index of each element
    of every sorted row."""
    common.guard_64bit_downcast(keys)
    keys = jnp.asarray(keys)
    if keys.ndim != 2:
        raise ValueError("argsort_batched expects a 2-D (batch, n) key array")
    ranks = jnp.broadcast_to(
        jnp.arange(keys.shape[1], dtype=jnp.uint32), keys.shape
    )
    return sort_batched(keys, ranks, **kwargs)[1]


@functools.partial(
    jax.jit, static_argnames=("bit_count", "descending", "total_order"),
)
def _sort_batched_jit(keys, values, *, bit_count, descending, total_order):
    B, n = keys.shape
    if B * n == 0 or n <= 1:
        return keys if values is None else (keys, values)

    if common.is_64bit_key_dtype(keys.dtype):
        if total_order:
            full_cols = common.to_total_order_u64_cols(keys)
        else:
            full_cols = common.to_sortable_u64_cols(keys)
        masks = common.bit_mask_cols(bit_count)
        masked = bit_count < 64
        mcols = tuple(c & m for c, m in zip(full_cols, masks))
        if descending:
            mcols = tuple(c ^ m for c, m in zip(mcols, masks))
        # bit_count <= 32: the masked hi column is all-zero — drop it
        mk_cols = (mcols[1],) if bit_count <= 32 else mcols
    else:
        if total_order:
            full_cols = (common.to_total_order_u32(keys),)
        else:
            full_cols = (common.to_sortable_u32(keys),)
        masks = (common.bit_mask(bit_count),)
        masked = bit_count < common.native_key_bits(keys.dtype)
        mk = full_cols[0] & masks[0]
        if descending:
            mk = mk ^ masks[0]
        mk_cols = (mk,)

    carry_full = masked or descending
    stable = carry_full or values is not None
    vcols = common.values_to_u32_cols(values) if values is not None else ()
    payloads = (*(full_cols if carry_full else ()), *vcols)
    out = jax.lax.sort(
        (*mk_cols, *payloads), num_keys=len(mk_cols), is_stable=stable,
        dimension=1,
    )
    nk = len(mk_cols)
    # unmasked ascending: the key columns ARE the full-key columns
    sorted_cols = out[nk: nk + len(full_cols)] if carry_full else out[:nk]

    if len(sorted_cols) == 2:
        s_hi, s_lo = sorted_cols
        if total_order:
            out_keys = common.from_total_order_u64_cols(s_hi, s_lo, keys.dtype)
        else:
            out_keys = common.from_sortable_u64_cols(s_hi, s_lo, keys.dtype)
    else:
        u = sorted_cols[0]
        if total_order:
            out_keys = common.from_total_order_u32(u, keys.dtype)
        else:
            out_keys = common.from_sortable_u32(u, keys.dtype)
    if values is None:
        return out_keys
    v_sorted = out[len(out) - len(vcols):]
    return out_keys, common.values_from_u32_cols(v_sorted, values.dtype)
