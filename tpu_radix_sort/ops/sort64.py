"""64-bit key sorts: uint64 / int64 / float64 (extension past the reference).

The reference is 32-bit-only (its WGSL buffers are ``array<u32>``,
``src/shaders/RadixSort.ts``); this module lifts the full option surface —
sub-`count`, `bit_count` (here 4..64), `check_order`, `descending`,
`total_order`, values — to 64-bit keys. A 64-bit key is two u32 columns
(hi, lo), sorted by `jax.lax.sort` with ``num_keys=2``; `bit_count <= 32`
drops the all-zero masked hi column and sorts on lo alone.

Input arrays must carry a real 64-bit dtype, which requires jax x64 mode
(``jax.config.update("jax_enable_x64", True)``) — without it JAX silently
downcasts at ``asarray`` time and the 32-bit path runs instead.
`check_order` gates the whole pipeline on a 64-bit order check
(`ops/checksort.py` two-column reduction).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import checksort, common
from .sort import engine_sort


def sort64(
    keys,
    values=None,
    *,
    count=None,
    bit_count: int = 64,
    check_order: bool = False,
    total_order: bool = False,
    descending: bool = False,
):
    """64-bit-key `sort` (called from :func:`ops.sort.sort` on dtype).

    Same contract as the 32-bit entrypoint; `bit_count` extends to 4..64
    (a multiple of 4), ordering by the low bits of the u64 bit pattern.
    """
    n = keys.shape[0]
    common.validate_bit_count_64(bit_count)
    count = n if count is None else int(count)
    if not (0 <= count <= n):
        raise ValueError(f"count {count} out of range for buffer of {n}")
    if values is not None:
        common.guard_64bit_value_downcast(values)
        values = jnp.asarray(values)
        if values.ndim != 1 or values.shape[0] != n:
            raise ValueError("values must be 1-D with the same length as keys")
        common.validate_value_dtype(values)
    mask_hi, mask_lo = common.bit_mask_cols(bit_count)
    out = _sort_jit64(
        keys,
        values,
        mask_hi,
        mask_lo,
        count=count,
        masked=bit_count < 64,
        lo_only=bit_count <= 32,
        check_order=check_order,
        total_order=total_order,
        descending=descending,
    )
    return out if values is not None else out[0]


@functools.partial(
    jax.jit,
    static_argnames=(
        "count",
        "masked",
        "lo_only",
        "check_order",
        "total_order",
        "descending",
    ),
)
def _sort_jit64(
    keys,
    values,
    mask_hi,
    mask_lo,
    *,
    count,
    masked,
    lo_only,
    check_order,
    total_order,
    descending,
):
    """Jitted 64-bit sort core (column-pair analogue of `sort._sort_jit`)."""
    n = keys.shape[0]
    if count <= 1:
        return keys, values

    if total_order:
        u_hi, u_lo = common.to_total_order_u64_cols(keys[:count])
    else:
        u_hi, u_lo = common.to_sortable_u64_cols(keys[:count])
    mk_hi = u_hi & mask_hi
    mk_lo = u_lo & mask_lo
    if descending:
        mk_hi = mk_hi ^ mask_hi
        mk_lo = mk_lo ^ mask_lo
    # bit_count <= 32: the masked hi column is all-zero — drop it from the
    # compare tuple (same order, one fewer column to sort)
    key_cols = (mk_lo,) if lo_only else (mk_hi, mk_lo)

    carry_full_key = masked
    stable = carry_full_key or values is not None

    payloads = []
    if carry_full_key:
        payloads += [u_hi, u_lo]
    vcols = ()
    if values is not None:
        vcols = common.values_to_u32_cols(values[:count])
        payloads.extend(vcols)

    def do_sort():
        kc, ps = engine_sort(key_cols, tuple(payloads), stable=stable)
        ps = list(ps)
        if carry_full_key:
            s_hi, s_lo = ps.pop(0), ps.pop(0)
        else:
            # not masked => bit_count == 64 => both columns in the tuple
            s_hi = kc[0] ^ mask_hi if descending else kc[0]
            s_lo = kc[1] ^ mask_lo if descending else kc[1]
        return (s_hi, s_lo, *ps[: len(vcols)])

    if check_order:
        passthrough = (u_hi, u_lo, *vcols)
        ok = checksort.is_sorted_cols(key_cols)
        result = jax.lax.cond(ok, lambda: passthrough, do_sort)
    else:
        result = do_sort()

    s_hi, s_lo = result[0], result[1]
    if total_order:
        out_keys = common.from_total_order_u64_cols(s_hi, s_lo, keys.dtype)
    else:
        out_keys = common.from_sortable_u64_cols(s_hi, s_lo, keys.dtype)
    if count < n:
        out_keys = jnp.concatenate([out_keys, keys[count:]])
    if values is None:
        return out_keys, None
    out_values = common.values_from_u32_cols(result[2:], values.dtype)
    if count < n:
        out_values = jnp.concatenate([out_values, values[count:]])
    return out_keys, out_values
