"""Distributed order-check gate for the mesh-level sorts.

Lifts the reference's CheckSort early-exit semantics
(`src/shaders/CheckSort.ts:139-145`: "is_sorted == 1 => zero every dispatch
record") to a device mesh: each shard runs the same fast-gated local check
the single-chip path uses (`ops/checksort.is_sorted` — fast 1024-element
prefix gating the full reduction), shard boundaries are
covered by ONE `ppermute` of each shard's first element, and the verdicts
combine with ONE `psum`. The callers wrap their sort `shard_map` in a
`lax.cond` on the replicated verdict — a nearly-sorted global array then
skips the whole exchange network.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops import checksort


def _lex_gt_scalar(a_last, b_first):
    """Lexicographic `last > next-shard-first` over parallel column tuples
    (1 column: plain compare; 2 columns: the 64-bit (hi, lo) key view)."""
    gt = a_last[-1] > b_first[-1]
    for a, b in zip(reversed(a_last[:-1]), reversed(b_first[:-1])):
        gt = (a > b) | ((a == b) & gt)
    return gt


def _shard_verdict(cols, *, axis_name, n_dev):
    """Per-shard body: local fast-gated check + boundary pair, psum'd.

    `cols` is a tuple holding this shard's slice of each padded masked-key
    column (one column for u32 keys, (hi, lo) for 64-bit) in its original
    (pre-sort) order; sentinel pads live at the global tail, so the global
    array is sorted iff the real prefix is.
    """
    ok_local = checksort.is_sorted_cols(cols)
    bad = (~ok_local).astype(jnp.uint32)
    if n_dev > 1:
        # boundary pairs: shard d's last element vs shard d+1's first.
        # Each shard sends its first element one shard to the LEFT; the
        # last shard's slot stays zero-filled and is masked out.
        perm = [(i, i - 1) for i in range(1, n_dev)]
        recv = tuple(
            jax.lax.ppermute(c[:1], axis_name, perm) for c in cols
        )
        me = jax.lax.axis_index(axis_name)
        gt = _lex_gt_scalar(
            tuple(c[-1] for c in cols), tuple(r[0] for r in recv)
        )
        boundary_bad = jnp.where(
            me < n_dev - 1, gt.astype(jnp.uint32), jnp.uint32(0)
        )
        bad = bad + boundary_bad
    return jax.lax.psum(bad, axis_name) == 0


def global_is_sorted(mk, *, mesh, axis_name, n_dev):
    """Replicated bool: is the sharded masked-key array globally sorted?

    One collective round (psum; plus one edge-element ppermute for D > 1).
    `mk` is one u32 column or a tuple of lexicographic columns (64-bit keys).
    """
    cols = mk if isinstance(mk, tuple) else (mk,)
    fn = jax.shard_map(
        functools.partial(
            _shard_verdict,
            axis_name=axis_name,
            n_dev=n_dev,
        ),
        mesh=mesh,
        in_specs=(tuple(P(axis_name) for _ in cols),),
        out_specs=P(),  # psum result is replicated
        check_vma=False,
    )
    return fn(cols)


def _shard_disorder(cols, *, axis_name, n_dev, count):
    """Per-shard body for the public distributed disorder count: elements at
    global index >= `count` become SENTINELs (all-equal max keys create no
    inversions), then the local reduction + the cross-shard boundary pair,
    psum'd."""
    L = cols[0].shape[0]
    me = jax.lax.axis_index(axis_name)
    gidx = me.astype(jnp.uint32) * jnp.uint32(L) + jnp.arange(
        L, dtype=jnp.uint32
    )
    in_count = gidx < jnp.uint32(count)
    cols = tuple(
        jnp.where(in_count, c, jnp.uint32(0xFFFFFFFF)) for c in cols
    )
    bad = checksort.disorder_count_cols(cols)
    if n_dev > 1:
        perm = [(i, i - 1) for i in range(1, n_dev)]
        recv = tuple(
            jax.lax.ppermute(c[:1], axis_name, perm) for c in cols
        )
        gt = _lex_gt_scalar(
            tuple(c[-1] for c in cols), tuple(r[0] for r in recv)
        )
        bad = bad + jnp.where(
            me < n_dev - 1, gt.astype(jnp.uint32), jnp.uint32(0)
        )
    return jax.lax.psum(bad, axis_name)


def _prep_check_input(u, *, count, bit_count, mesh, axis_name,
                      total_order=False, descending=False):
    """Shared validation + key-view + SENTINEL pad for the public mesh
    checks. Returns (tuple of u32 columns of length round_up(n, D), count) —
    one column for 32-bit keys, (hi, lo) for 64-bit dtypes. The
    `total_order`/`descending` flags select the same key view the
    correspondingly-flagged sort ordered by."""
    from ..ops import common

    common.guard_64bit_downcast(u)
    u = jnp.asarray(u)
    if common.is_64bit_key_dtype(u.dtype):
        cols = checksort._as_check_key_cols(
            u, 64 if bit_count is None else bit_count,
            total_order=total_order, descending=descending,
        )
    else:
        if bit_count is None:
            bit_count = common.native_key_bits(u.dtype)
        common.validate_bit_count_for(u.dtype, bit_count)
        cols = (checksort._as_check_key(
            u, bit_count, total_order=total_order, descending=descending),)
    n = cols[0].shape[0]
    count = n if count is None else int(count)
    if not (0 <= count <= n):
        raise ValueError(f"count {count} out of range for buffer of {n}")
    n_dev = mesh.shape[axis_name]
    n_pad = common.round_up(max(n, n_dev), n_dev)
    return (
        tuple(common.pad_to(c, n_pad, common.SENTINEL_U32) for c in cols),
        count,
    )


def mesh_disorder_count(u, *, mesh, axis_name="x", count=None,
                        bit_count: int | None = None,
                        total_order: bool = False, descending: bool = False):
    """Distributed adjacent-inversion count of the first `count` keys.

    Public mesh lift of :func:`tpu_radix_sort.disorder_count` (the
    reference's CheckSort reduction, `src/shaders/CheckSort.ts:70-113`):
    per-shard reductions + one edge-element `ppermute` +
    one `psum`. Same `count`/`bit_count`/`total_order`/`descending`/dtype
    semantics as single-chip.
    """
    cols, count = _prep_check_input(
        u, count=count, bit_count=bit_count, mesh=mesh, axis_name=axis_name,
        total_order=total_order, descending=descending,
    )
    if count < 2:
        return jnp.uint32(0)
    return _disorder_core(cols, mesh=mesh, axis_name=axis_name, count=count)


@functools.partial(jax.jit, static_argnames=("mesh", "axis_name", "count"))
def _disorder_core(cols, *, mesh, axis_name, count):
    n_dev = mesh.shape[axis_name]
    fn = jax.shard_map(
        functools.partial(
            _shard_disorder,
            axis_name=axis_name,
            n_dev=n_dev,
            count=count,
        ),
        mesh=mesh,
        in_specs=(tuple(P(axis_name) for _ in cols),),
        out_specs=P(),
        check_vma=False,
    )
    return fn(cols)


def mesh_is_sorted(u, *, mesh, axis_name="x", count=None,
                   bit_count: int | None = None,
                   total_order: bool = False, descending: bool = False):
    """Distributed fast-gated order check of the first `count` keys.

    Public mesh lift of :func:`tpu_radix_sort.is_sorted`: each shard runs
    the fast(1024)-gated local check, boundary pairs ride one `ppermute`,
    verdicts combine in one `psum` (same machinery that gates the
    distributed sorts' `check_order=True`). `total_order`/`descending`
    select the correspondingly-flagged sort's key view.
    """
    cols, count = _prep_check_input(
        u, count=count, bit_count=bit_count, mesh=mesh, axis_name=axis_name,
        total_order=total_order, descending=descending,
    )
    if count < 2:
        return jnp.bool_(True)
    return _is_sorted_core(cols, mesh=mesh, axis_name=axis_name, count=count)


@functools.partial(jax.jit, static_argnames=("mesh", "axis_name", "count"))
def _is_sorted_core(cols, *, mesh, axis_name, count):
    n_dev = mesh.shape[axis_name]
    # elements past count become SENTINELs (elementwise, so XLA applies it
    # shard-local) — the padded-sorted-tail invariant global_is_sorted's
    # sort callers already maintain
    in_count = jnp.arange(cols[0].shape[0], dtype=jnp.uint32) < jnp.uint32(count)
    cols = tuple(jnp.where(in_count, c, jnp.uint32(0xFFFFFFFF)) for c in cols)
    return global_is_sorted(cols, mesh=mesh, axis_name=axis_name, n_dev=n_dev)
