"""Order-check reduction and early-exit gating.

Reference counterpart: the CheckSort kernel family — a tree reduction of the
adjacent-pair disorder indicator `keys[i] > keys[i+1]`
(`src/shaders/CheckSort.ts:102-113`), split into a cheap "fast" check over
the first `4 * threads` elements that gates the "full" check over the rest,
with results steering GPU-side indirect-dispatch records
(`src/shaders/CheckSort.ts:115-145`, `AbstractRadixSortKernel.ts:249-276`).

Here the disorder reduction is one XLA compare-and-sum over the adjacent
pairs (the reference's multi-level reduction tree exists only because GPU
workgroups cannot communicate within a dispatch; XLA fuses the compare into
the reduction), and "zeroing the dispatch record" becomes `lax.cond` over
the whole sort computation. The fast/full split is kept: the fast slice's
verdict gates whether the full reduction runs at all.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import common

# Matches the reference's fast-check window: the first min(count, 4*threads)
# elements with the default 256-thread workgroup (AbstractRadixSortKernel.ts:139).
FAST_CHECK_ELEMENTS = 1024


def disorder_count_cols(cols) -> jax.Array:
    """Adjacent inversions of the lexicographic column tuple (1 or 2 u32
    columns — the plain and 64-bit key views)."""
    n = cols[0].shape[0]
    if n < 2:
        return jnp.uint32(0)
    gt = common.lex_lt(tuple(c[1:] for c in cols), tuple(c[:-1] for c in cols))
    return jnp.sum(gt.astype(jnp.uint32), dtype=jnp.uint32)


def is_sorted_cols(cols) -> jax.Array:
    """Fast-gated order check on a lexicographic column tuple (the 64-bit
    analogue of :func:`is_sorted`; same fast-window-then-rest structure —
    one implementation for any column count)."""
    n = cols[0].shape[0]
    f = min(n, FAST_CHECK_ELEMENTS)
    fast_ok = disorder_count_cols(tuple(c[:f] for c in cols)) == 0
    if f >= n:
        return fast_ok
    # include the boundary pair by starting at f - 1
    return jax.lax.cond(
        fast_ok,
        lambda: disorder_count_cols(
            tuple(jax.lax.slice(c, (f - 1,), (n,)) for c in cols)
        ) == 0,
        lambda: jnp.bool_(False),
    )


def _as_check_key(u: jax.Array, bit_count: int, *, total_order=False,
                  descending=False) -> jax.Array:
    """Map keys to the masked u32 word the order check compares.

    Mirrors the sort's own key view (the exact `_sort_jit` mkeys pipeline):
    u32 bit pattern (`to_sortable_u32`, or the `to_total_order_u32`
    bijection when the sort ran with `total_order=True`) masked to the low
    `bit_count` bits, XOR-flipped when checking `descending=True` output —
    the reference's check kernels compare the same storage words the sort
    kernels order by (`src/shaders/CheckSort.ts:102-113`); these flags keep
    that contract for every option the sort accepts.
    """
    u = jnp.asarray(u)
    if total_order:
        u = common.to_total_order_u32(u)
    else:
        u = common.to_sortable_u32(u)
    if bit_count < 32:
        u = u & common.bit_mask(bit_count)
    if descending:
        u = u ^ common.bit_mask(bit_count)
    return u


def _as_check_key_cols(u: jax.Array, bit_count: int, *, total_order=False,
                       descending=False):
    """64-bit keys' check view: masked (hi, lo) u32 columns ((lo,) alone
    when bit_count <= 32 — the hi column is all-zero then), with the same
    `total_order`/`descending` view transforms as :func:`_as_check_key`."""
    common.validate_bit_count_64(bit_count)
    if total_order:
        hi, lo = common.to_total_order_u64_cols(u)
    else:
        hi, lo = common.to_sortable_u64_cols(u)
    mask_hi, mask_lo = common.bit_mask_cols(bit_count)
    hi, lo = hi & mask_hi, lo & mask_lo
    if descending:
        hi, lo = hi ^ mask_hi, lo ^ mask_lo
    if bit_count <= 32:
        return (lo,)
    return (hi, lo)


def disorder_count(
    u: jax.Array, *, count=None, bit_count: int | None = None,
    total_order: bool = False, descending: bool = False,
    mesh=None, axis_name: str = "x",
) -> jax.Array:
    """Number of adjacent inversions in the first `count` keys (0 == sorted).

    `count`/`bit_count` mirror the reference check kernels' ELEMENT_COUNT /
    key-width overrides for checking a slice of a larger buffer
    (`src/kernels/check-sort/CheckSortBufferKernel.ts:84-103`); comparison is
    on the low `bit_count` bits of the u32 bit pattern, like the sort itself.
    `total_order`/`descending` check under the corresponding sort options'
    key view (pass the same flags the sort ran with) — the check always
    compares the same words the sort ordered by.

    One fused compare-and-sum pass (the reference's `check_sort` kernel,
    `src/shaders/CheckSort.ts:70-113`). ``mesh=`` runs it across a
    `jax.sharding.Mesh` axis (per-shard reductions + one ppermute + one
    psum, `parallel/check.py`).
    """
    if mesh is not None:
        from ..parallel.check import mesh_disorder_count

        return mesh_disorder_count(
            u, mesh=mesh, axis_name=axis_name, count=count,
            bit_count=bit_count, total_order=total_order,
            descending=descending,
        )
    common.guard_64bit_downcast(u)
    u = jnp.asarray(u)
    if common.is_64bit_key_dtype(u.dtype):
        cols = _as_check_key_cols(
            u, 64 if bit_count is None else bit_count,
            total_order=total_order, descending=descending,
        )
        if count is not None:
            count = int(count)
            if not (0 <= count <= u.shape[0]):
                raise ValueError(
                    f"count {count} out of range for buffer of {u.shape[0]}"
                )
            cols = tuple(c[:count] for c in cols)
        return disorder_count_cols(cols)
    if bit_count is None:
        bit_count = common.native_key_bits(u.dtype)
    common.validate_bit_count_for(u.dtype, bit_count)
    u = _as_check_key(u, bit_count, total_order=total_order,
                      descending=descending)
    if count is not None:
        count = int(count)
        if not (0 <= count <= u.shape[0]):
            raise ValueError(f"count {count} out of range for buffer of {u.shape[0]}")
        u = u[:count]
    return disorder_count_cols((u,))


def is_sorted(
    u: jax.Array, *, count=None, bit_count: int | None = None,
    total_order: bool = False, descending: bool = False,
    mesh=None, axis_name: str = "x",
) -> jax.Array:
    """Fast-gated full order check, mirroring the reference's two-phase check.

    The fast phase samples the first FAST_CHECK_ELEMENTS keys; only if that
    prefix is ordered does the full reduction over the remainder run
    (reference overlaps the boundary pair by starting the full check at
    fast_count - 1, AbstractRadixSortKernel.ts:139-141). `count`/`bit_count`
    check a prefix of a larger buffer on the low key bits, like the
    reference's START_ELEMENT/ELEMENT_COUNT overrides
    (`CheckSortBufferKernel.ts:84-103`). `total_order`/`descending` verify
    output of the correspondingly-flagged sort (same key view). ``mesh=``
    runs the fast-gated check across a `jax.sharding.Mesh` axis
    (`parallel/check.py` — the same gate the distributed sorts'
    `check_order=True` uses).
    """
    if mesh is not None:
        from ..parallel.check import mesh_is_sorted

        return mesh_is_sorted(
            u, mesh=mesh, axis_name=axis_name, count=count,
            bit_count=bit_count, total_order=total_order,
            descending=descending,
        )
    common.guard_64bit_downcast(u)
    u = jnp.asarray(u)
    if common.is_64bit_key_dtype(u.dtype):
        cols = _as_check_key_cols(
            u, 64 if bit_count is None else bit_count,
            total_order=total_order, descending=descending,
        )
        if count is not None:
            count = int(count)
            if not (0 <= count <= u.shape[0]):
                raise ValueError(
                    f"count {count} out of range for buffer of {u.shape[0]}"
                )
            cols = tuple(c[:count] for c in cols)
        return is_sorted_cols(cols)
    if bit_count is None:
        bit_count = common.native_key_bits(u.dtype)
    common.validate_bit_count_for(u.dtype, bit_count)
    u = _as_check_key(u, bit_count, total_order=total_order,
                      descending=descending)
    if count is not None:
        count = int(count)
        if not (0 <= count <= u.shape[0]):
            raise ValueError(f"count {count} out of range for buffer of {u.shape[0]}")
        u = u[:count]
    return is_sorted_cols((u,))


def with_early_exit(u_sorted_check: jax.Array, passthrough, compute_fn):
    """Return passthrough unchanged if already sorted, else compute_fn().

    `passthrough` and `compute_fn()` must be pytrees of identical structure.
    This is the `lax.cond` analogue of the reference zeroing every dispatch
    record when `is_sorted == 1` (src/shaders/CheckSort.ts:139-145).
    """
    ok = is_sorted_cols((u_sorted_check,))
    return jax.lax.cond(ok, lambda: passthrough, compute_fn)
