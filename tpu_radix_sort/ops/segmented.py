"""Segmented sorts: independently sort variable-length segments of a flat
array (the ragged generalization of `ops/batched.py`).

Extension past the reference. Segments are defined CSR-style by an
`offsets` array (length S+1, offsets[0] == 0, offsets[-1] == n,
nondecreasing; empty segments allowed). Ragged segments cannot be a
batch axis, so the engine here is a *composite key*: sorting the flat array by (segment_id, key)
lexicographically sorts every segment in place — segment id dominates, so
elements never leave their segment's contiguous range, and within it the
order is by key. The segment id either packs into the same u32 word above
the masked key bits (ceil(log2(S)) + bit_count <= 32: one key column, the
cost of a flat masked sort) or rides as a leading key column of
`jax.lax.sort` (``num_keys`` = 2 or 3).

`offsets` is a traced operand (one compiled pipeline serves every
segmentation of the same shape); segment ids (and starts, for ranks) come
from tiny boundary scatters and one `jnp.cumsum` each.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import common
from .sort import engine_sort, validate_method


def sort_segments(
    keys,
    offsets,
    values=None,
    *,
    bit_count: int | None = None,
    descending: bool = False,
    total_order: bool = False,
    method: str = "auto",
    mesh=None,
    axis_name: str = "x",
):
    """Stable ascending sort of each segment `[offsets[i], offsets[i+1])`
    of a flat 1-D key array, co-permuting optional 4- or 8-byte `values`.

    `offsets`: 1-D integer array, length S+1, with offsets[0] == 0,
    offsets[-1] == len(keys), nondecreasing (CSR segment boundaries; this
    contract is the caller's — offsets are traced, not validated).
    Same key-dtype/option surface as :func:`sort` (64-bit dtypes under
    jax x64). Returns keys or (keys, values), same shape.

    ``mesh=`` routes the same call across a mesh axis: segment ids come
    from the distributed prefix sum and the composite (seg, key, idx)
    tuple rides the compare-split network (`parallel/segmented.py`).
    """
    common.guard_64bit_downcast(keys)
    keys = jnp.asarray(keys)
    if keys.ndim != 1:
        raise ValueError("sort_segments expects a 1-D key array")
    offsets = jnp.asarray(offsets)
    if offsets.ndim != 1 or offsets.shape[0] < 2:
        raise ValueError("offsets must be 1-D with length >= 2 (S+1 bounds)")
    if not jnp.issubdtype(offsets.dtype, jnp.integer):
        raise TypeError("offsets must be an integer array")
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
    if mesh is not None:
        if method not in ("auto", "mesh"):
            raise ValueError(
                "with mesh=, sort_segments supports method in "
                f"('auto', 'mesh'); got {method!r}"
            )
        from ..parallel.segmented import mesh_sort_segments

        return mesh_sort_segments(
            keys, offsets, values,
            mesh=mesh, axis_name=axis_name, bit_count=bit_count,
            descending=descending, total_order=total_order,
            make_ranks=False,
        )
    validate_method(method)
    return _sort_segments_jit(
        keys,
        offsets,
        values,
        bit_count=bit_count,
        descending=descending,
        total_order=total_order,
        make_ranks=False,
    )


def argsort_segments(keys, offsets, *, bit_count=None, descending=False,
                     total_order=False, method="auto", mesh=None,
                     axis_name="x"):
    """Per-segment stable argsort: for each position of the segment-sorted
    output, the original index of that element relative to its segment's
    start. The position-minus-segment-start payload is built inside the
    jitted core from the same boundary scan that produces the segment ids.
    ``mesh=`` routes distributed (see :func:`sort_segments`)."""
    common.guard_64bit_downcast(keys)
    keys = jnp.asarray(keys)
    if keys.ndim != 1:
        raise ValueError("argsort_segments expects a 1-D key array")
    offsets = jnp.asarray(offsets)
    wide = common.is_64bit_key_dtype(keys.dtype)
    if bit_count is None:
        bit_count = 64 if wide else 32
    if mesh is not None:
        if method not in ("auto", "mesh"):
            raise ValueError(
                "with mesh=, argsort_segments supports method in "
                f"('auto', 'mesh'); got {method!r}"
            )
        from ..parallel.segmented import mesh_sort_segments

        return mesh_sort_segments(
            keys, offsets, None,
            mesh=mesh, axis_name=axis_name, bit_count=bit_count,
            descending=descending, total_order=total_order,
            make_ranks=True,
        )[1]
    validate_method(method)
    return _sort_segments_jit(
        keys,
        offsets,
        None,
        bit_count=bit_count,
        descending=descending,
        total_order=total_order,
        make_ranks=True,
    )[1]


def segment_boundary_deltas(offsets, n, *, need_starts):
    """Per-position increments whose inclusive prefix sums are the segment
    id and, with `need_starts`, the segment start of every position.

    - seg id: +1 at each interior boundary — the count of boundaries <= j
      IS the segment id (coincident boundaries from empty segments
      accumulate, advancing the id by their multiplicity).
    - seg start: +(offsets[i] - offsets[i-1]) at boundary i telescopes
      under the scan to the largest boundary <= j, i.e. the segment start.

    Only S-1 elements are scattered; the scan is the caller's (one chip:
    `jnp.cumsum`; a mesh: the distributed prefix sum).
    """
    b = offsets[1:-1].astype(jnp.int32)  # interior boundaries (S-1)
    ind = jnp.zeros((n,), jnp.uint32).at[b].add(jnp.uint32(1), mode="drop")
    if not need_starts:
        return ind, None
    delta = (offsets[1:-1] - offsets[:-2]).astype(jnp.uint32)
    d = jnp.zeros((n,), jnp.uint32).at[b].add(delta, mode="drop")
    return ind, d


@functools.partial(
    jax.jit,
    static_argnames=(
        "bit_count",
        "descending",
        "total_order",
        "make_ranks",
    ),
)
def _sort_segments_jit(
    keys,
    offsets,
    values,
    *,
    bit_count,
    descending,
    total_order,
    make_ranks,
):
    n = keys.shape[0]
    S = offsets.shape[0] - 1
    have_values = values is not None or make_ranks
    if n <= 1:
        if make_ranks:
            return keys, jnp.zeros((n,), jnp.uint32)
        return keys if values is None else (keys, values)

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
        # seg ids pack above the real key bits; 16-bit keys leave 16+ spare
        key_width = bit_count

    ind, d = segment_boundary_deltas(offsets, n, need_starts=make_ranks)
    seg = jnp.cumsum(ind, dtype=jnp.uint32)
    seg_bits = max(1, (S - 1).bit_length())
    packed = not wide and seg_bits + key_width <= 32
    if packed:
        # composite single column: segment id above the masked key bits
        key_cols = ((seg << key_width) | mk_cols[0],)
    else:
        key_cols = (seg, *mk_cols)

    ranks = None
    if make_ranks:
        ranks = jnp.arange(n, dtype=jnp.uint32) - jnp.cumsum(
            d, dtype=jnp.uint32)

    carry_full = masked or descending
    stable = carry_full or have_values

    if make_ranks:
        vcols = (ranks,)
    elif values is not None:
        # 8-byte value dtypes ride as an (hi, lo) u32 column pair
        vcols = common.values_to_u32_cols(values)
    else:
        vcols = ()

    payloads = list(full_cols) if carry_full else []
    payloads.extend(vcols)
    kc, out = engine_sort(key_cols, tuple(payloads), stable=stable)
    if carry_full:
        sorted_cols = out[: len(full_cols)]
    elif packed:
        # unmasked ascending keys packed under the seg id in ONE column
        # with nothing carried: unmask the key bits back out
        sorted_cols = (kc[0] & common.bit_mask(key_width),)
    else:
        # unmasked ascending with a separate leading segment column: the
        # key column(s) after it ARE the full storage words
        sorted_cols = kc[1:]
    v_sorted = out[len(out) - len(vcols):] if have_values else None

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
    if make_ranks:
        return out_keys, v_sorted[0]  # already uint32 ranks
    return out_keys, common.values_from_u32_cols(v_sorted, values.dtype)
