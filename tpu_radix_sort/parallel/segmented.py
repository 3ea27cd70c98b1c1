"""Distributed segmented (ragged) sorts over a `jax.sharding.Mesh` axis.

The reference is single-GPU and has no segmented op at all; this lifts the
composite-key engine (`ops/segmented.py`) to the cross-device layer the
same way `mesh_sort` lifts the flat sort (SURVEY.md §2.4). The mechanism
composes two existing subsystems, adding no new collective kinds:

- segment ids / starts come from the SAME boundary-scatter trick as the
  single-chip path, but scanned with the DISTRIBUTED prefix sum
  (`parallel/scan.py` — per-shard scan + one tiny all_gather);
- the composite (segment_id, key, idx) column tuple then rides the
  compare-split network (`mesh_sort._shard_sort`) unchanged — segment id
  dominates the lexicographic compare, so elements never leave their
  segment's global range, and the shard-local index tie-break keeps the
  sort stable exactly as for flat keys.

Narrow keys whose seg_bits + bit_count <= 32 pack segment id and key into
ONE u32 column (same packing rule as single-chip), so the common case
moves zero extra exchange bytes vs a flat mesh_sort.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import common
from ..ops.segmented import segment_boundary_deltas
# NOTE: `from . import mesh_sort` would resolve to the FUNCTION (the
# package __init__ rebinds the name); import the symbol directly.
from .mesh_sort import MIN_SHARD_LEN, _shard_sort
from .scan import mesh_prefix_sum


def _mesh_segment_ids_and_starts(offsets, n, *, mesh, axis_name,
                                 need_starts):
    """Element position -> (segment id, segment start), distributed: the
    single-chip boundary deltas, scanned with the mesh prefix sum (whose
    only collective is one (1,)-per-shard all_gather of shard totals)."""
    ind, d = segment_boundary_deltas(offsets, n, need_starts=need_starts)
    seg = mesh_prefix_sum(ind, mesh=mesh, axis_name=axis_name, inclusive=True)
    if not need_starts:
        return seg, None
    starts = mesh_prefix_sum(d, mesh=mesh, axis_name=axis_name, inclusive=True)
    return seg, starts


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis_name", "bit_count", "descending",
                     "total_order", "make_ranks", "overlap_chunks"),
)
def mesh_sort_segments(
    keys,
    offsets,
    values=None,
    *,
    mesh: Mesh,
    axis_name: str = "x",
    bit_count: int,
    descending: bool = False,
    total_order: bool = False,
    make_ranks: bool = False,
    overlap_chunks: int = 1,
):
    """Distributed core of `sort_segments(mesh=)` / `argsort_segments(mesh=)`.

    Callers (the public wrappers in `ops/segmented.py`) have already
    validated dtypes/shapes and resolved `bit_count`. Semantics match the
    single-chip `_sort_segments_jit`: stable ascending (or per-flag) sort
    of every CSR segment `[offsets[i], offsets[i+1])`, suffix rules N/A
    (segments tile the whole array). With `make_ranks`, returns
    (sorted_keys, per-segment ranks) like the single-chip argsort path.
    """
    n = keys.shape[0]
    S = offsets.shape[0] - 1
    n_dev = mesh.shape[axis_name]
    have_values = values is not None or make_ranks
    if n <= 1:
        if make_ranks:
            return keys, jnp.zeros((n,), jnp.uint32)
        return keys if values is None else (keys, values)

    # key transform: identical to the single-chip composite engine
    if wide := common.is_64bit_key_dtype(keys.dtype):
        if total_order:
            full_cols = common.to_total_order_u64_cols(keys)
        else:
            full_cols = common.to_sortable_u64_cols(keys)
        masks = common.bit_mask_cols(bit_count)
        masked = bit_count < 64
        lo_only = bit_count <= 32
        mcols = tuple(c & m for c, m in zip(full_cols, masks))
        if descending:
            mcols = tuple(c ^ m for c, m in zip(mcols, masks))
        mk_cols = (mcols[1],) if lo_only else mcols
        key_width = 32  # segment bits never pack into a 64-bit pair
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
        key_width = bit_count

    seg, seg_starts = _mesh_segment_ids_and_starts(
        offsets, n, mesh=mesh, axis_name=axis_name, need_starts=make_ranks,
    )
    seg_bits = max(1, (S - 1).bit_length())
    packed = not wide and seg_bits + key_width <= 32
    if packed:
        key_cols = ((seg << key_width) | mk_cols[0],)
    else:
        key_cols = (seg, *mk_cols)

    ranks = None
    if make_ranks:
        ranks = jnp.arange(n, dtype=jnp.uint32) - seg_starts

    carry_full = masked or descending
    if make_ranks:
        vcols = (ranks,)
    elif values is not None:
        vcols = common.values_to_u32_cols(values)
    else:
        vcols = ()

    # pad to a pow2 per-shard length; sentinel composite/segment
    # keys sort to the global tail (ties against a real 0xFFFFFFFF packed
    # key resolve by the idx column: real elements carry idx < n)
    per = max(MIN_SHARD_LEN, common.next_pow2(common.cdiv(n, n_dev)))
    n_pad = per * n_dev
    arrs = [common.pad_to(c, n_pad, common.SENTINEL_U32) for c in key_cols]
    arrs.append(jnp.arange(n_pad, dtype=jnp.uint32))
    nk = len(key_cols) + 1
    if carry_full:
        arrs += [
            common.pad_to(c, n_pad, common.SENTINEL_U32) for c in full_cols
        ]
    arrs += [common.pad_to(c, n_pad, jnp.uint32(0)) for c in vcols]

    fn = jax.shard_map(
        functools.partial(
            _shard_sort,
            axis_name=axis_name,
            n_dev=n_dev,
            overlap_chunks=overlap_chunks,
            nk=nk,
        ),
        mesh=mesh,
        in_specs=(tuple(P(axis_name) for _ in arrs),),
        out_specs=tuple(P(axis_name) for _ in arrs),
        check_vma=False,
    )
    out = fn(tuple(arrs))

    n_full = len(full_cols)
    if carry_full:
        sorted_cols = out[nk: nk + n_full]
    elif packed:
        # unmasked ascending keys packed under the seg id: unmask them out
        sorted_cols = (out[0] & common.bit_mask(key_width),)
    else:
        # unmasked ascending with a separate leading segment column: the
        # key column(s) after it ARE the full storage words
        sorted_cols = out[1: 1 + n_full]
    sorted_cols = tuple(c[:n] for c in sorted_cols)
    if wide:
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
    if not have_values:
        return out_keys
    vbase = nk + (n_full if carry_full else 0)
    v_sorted = tuple(c[:n] for c in out[vbase: vbase + len(vcols)])
    if make_ranks:
        return out_keys, v_sorted[0]  # already uint32 ranks
    return out_keys, common.values_from_u32_cols(v_sorted, values.dtype)
