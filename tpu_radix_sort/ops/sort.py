"""Top-level functional sort: feature assembly around the engines.

Reproduces the reference's full option surface
(`src/kernels/radix-sort/AbstractRadixSortKernel.ts:52-57`,
`RadixSortBufferKernel.ts:14-23`, `README.md:72-99`):

- keys-only or key+value (`hasValues`, `RadixSortBufferKernel.ts:34-36`)
- sort only the first `count` elements of a larger buffer, suffix untouched
  (`example/tests.ts:31,56`)
- `bit_count` in 4..32, multiple of 4: order by the low bits only
  (`AbstractRadixSortKernel.ts:94-107`)
- uint32 keys; float32/int32 ordered by u32 bit pattern like the reference
  (`README.md:9,68,95`), or by true total order with `total_order=True`
  (extension past the reference's non-negative restriction)
- `check_order` early exit for nearly-sorted input (`README.md:131-158`)
- stable, ascending (`README.md:94`)

The engine is `jax.lax.sort` over u32 columns: the masked (possibly
flipped) key, then payload columns. On a GPU, XLA hands a sort of one or
two such columns to CUB's radix sort; wider column tuples run XLA's own
sort kernel. `method` accepts 'auto' and 'xla', which are the same engine.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import checksort, common

_METHODS = ("auto", "xla")
# distributed strategies selectable through the same `method` knob once a
# `mesh=` is passed (single entrypoint, like the reference's one kernel
# class hiding its dispatch choices, `AbstractRadixSortKernel.ts:52-57`)
_MESH_METHODS = ("auto", "mesh", "exchange")


def validate_method(method: str) -> None:
    """Single-chip engine choice: 'auto' and 'xla' both run `lax.sort`."""
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")


def engine_sort(key_cols, payloads, *, stable):
    """Sort by the lexicographic u32 key-column tuple, co-permuting payloads.

    Returns (sorted key columns, sorted payloads) as tuples.
    """
    nk = len(key_cols)
    out = jax.lax.sort((*key_cols, *payloads), num_keys=nk, is_stable=stable)
    return tuple(out[:nk]), tuple(out[nk:])


def sort(
    keys,
    values=None,
    *,
    count=None,
    bit_count: int | None = None,
    check_order: bool = False,
    total_order: bool = False,
    descending: bool = False,
    method: str = "auto",
    mesh=None,
    axis_name: str = "x",
):
    """Stable sort with the reference's semantics (ascending by default).

    Returns sorted keys, or (keys, values) when values is given. Elements at
    index >= count are returned untouched. `descending=True` is an extension
    past the reference (which is ascending-only, `README.md:94`): stable
    descending via an ascending sort of the bit-flipped masked key.

    Key dtypes: uint32/float32/int32 (the reference's u32 bit-pattern
    contract, `README.md:9,68,95`); 16-bit dtypes (uint16/int16/float16/
    bfloat16 — widened u16 bit pattern, bit_count caps at 16) and 64-bit
    dtypes (uint64/int64/float64 under jax x64 — (hi, lo) u32 columns,
    bit_count up to 64) are extensions. `values` accepts any 4- or 8-byte
    dtype (8-byte rides as an (hi, lo) u32 column pair, x64 required).

    ``mesh=`` routes the same call across a `jax.sharding.Mesh` axis
    (shard inputs along `axis_name`): `method='auto'` picks the
    exact-splitter radix exchange (:func:`tpu_radix_sort.exchange_sort`,
    one data crossing per element) for meshes larger than 4 devices and the
    compare-split network (:func:`tpu_radix_sort.mesh_sort`, skew-immune
    fixed-size ppermutes) for small ones; `method='mesh'` or `'exchange'`
    forces a strategy.
    """
    if mesh is not None:
        if method not in _MESH_METHODS:
            raise ValueError(
                f"with mesh=, method must be one of {_MESH_METHODS}, "
                f"got {method}"
            )
        from .. import parallel  # local import: ops must not require parallel

        if method == "auto":
            # crossing-volume heuristic: compare-split moves each element
            # log2(D)(log2(D)+1)/2 times vs the exchange's once, but needs
            # no splitter and no ragged collective; 4 is the break
            method = "mesh" if mesh.shape[axis_name] <= 4 else "exchange"
        fn = parallel.mesh_sort if method == "mesh" else parallel.exchange_sort
        return fn(
            keys,
            values,
            mesh=mesh,
            axis_name=axis_name,
            count=count,
            bit_count=bit_count,
            check_order=check_order,
            total_order=total_order,
            descending=descending,
        )

    common.guard_64bit_downcast(keys)
    keys = jnp.asarray(keys)
    if keys.ndim != 1:
        raise ValueError("keys must be 1-D")
    validate_method(method)
    if common.is_64bit_key_dtype(keys.dtype):
        # 64-bit keys (extension; needs jax x64 mode so the dtype survives
        # asarray): (hi, lo) u32 column pair — ops/sort64.py. bit_count
        # defaults to the full key width.
        from . import sort64

        return sort64.sort64(
            keys,
            values,
            count=count,
            bit_count=64 if bit_count is None else bit_count,
            check_order=check_order,
            total_order=total_order,
            descending=descending,
        )
    narrow16 = common.is_16bit_key_dtype(keys.dtype)
    if keys.dtype not in (jnp.uint32, jnp.float32, jnp.int32) and not narrow16:
        raise TypeError(f"unsupported key dtype {keys.dtype}")
    # 16-bit keys (u16/i16/f16/bf16) widen to their u16 bit pattern in a
    # u32 lane; bit_count then defaults to (and caps at) 16
    native_bits = 16 if narrow16 else 32
    bit_count = native_bits if bit_count is None else bit_count
    common.validate_bit_count_for(keys.dtype, bit_count)
    n = keys.shape[0]
    count = n if count is None else int(count)
    if not (0 <= count <= n):
        raise ValueError(f"count {count} out of range for buffer of {n}")
    if values is not None:
        common.guard_64bit_value_downcast(values)
        values = jnp.asarray(values)
        if values.ndim != 1 or values.shape[0] != n:
            raise ValueError("values must be 1-D with the same length as keys")
        common.validate_value_dtype(values)

    # the mask is a traced operand so every bit_count shares one compiled
    # pipeline (two traces total: masked vs full-width key)
    out = _sort_jit(
        keys,
        values,
        common.bit_mask(bit_count),
        count=count,
        masked=bit_count < native_bits,
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
        "check_order",
        "total_order",
        "descending",
    ),
)
def _sort_jit(
    keys,
    values,
    mask,
    *,
    count,
    masked,
    check_order,
    total_order,
    descending=False,
):
    """Jitted sort core; one compiled pipeline per static configuration.

    Always returns (keys, values_or_None).
    """
    n = keys.shape[0]

    if count <= 1:
        return keys, values

    if total_order:
        u_full = common.to_total_order_u32(keys[:count])
    else:
        u_full = common.to_sortable_u32(keys[:count])
    mkeys = u_full & mask
    if descending:
        # stable descending == stable ascending on the flipped masked key
        # (flipped keys equal <=> keys equal, so stability carries over)
        mkeys = mkeys ^ mask

    # a masked key loses its high bits, so the full key rides as a payload
    carry_full_key = masked
    stable = carry_full_key or values is not None

    payloads = []
    if carry_full_key:
        payloads.append(u_full)
    vcols = ()
    if values is not None:
        # 8-byte value dtypes ride as an (hi, lo) u32 column pair
        # (capability superset of the reference's u32 payload buffers)
        vcols = common.values_to_u32_cols(values[:count])
        payloads.extend(vcols)

    def do_sort():
        (mk,), ps = engine_sort((mkeys,), tuple(payloads), stable=stable)
        ps = list(ps)
        if carry_full_key:
            u_sorted = ps.pop(0)
        else:
            u_sorted = mk ^ mask if descending else mk
        return (u_sorted, *ps[: len(vcols)])

    if check_order:
        # up-front gate: already-sorted input skips the sort entirely
        passthrough = (u_full, *vcols)
        result = checksort.with_early_exit(mkeys, passthrough, do_sort)
    else:
        result = do_sort()

    u_sorted = result[0]
    if total_order:
        out_keys = common.from_total_order_u32(u_sorted, keys.dtype)
    else:
        out_keys = common.from_sortable_u32(u_sorted, keys.dtype)
    if count < n:
        out_keys = jnp.concatenate([out_keys, keys[count:]])
    if values is None:
        return out_keys, None
    out_values = common.values_from_u32_cols(result[1:], values.dtype)
    if count < n:
        out_values = jnp.concatenate([out_values, values[count:]])
    return out_keys, out_values


def argsort(keys, **kwargs):
    """Indices that stably sort keys (reference pattern: values = iota,
    `example/tests.ts:38`)."""
    common.guard_64bit_downcast(keys)
    keys = jnp.asarray(keys)
    idx = jnp.arange(keys.shape[0], dtype=jnp.uint32)
    _, out = sort(keys, idx, **kwargs)
    return out


def sort_packed(packed, *, count=None, **kwargs):
    """Sort packed (key, value) records: array [..., 2] u32, key in [..., 0].

    Equivalent of the reference's texture kernel, which sorts
    rg32uint texels with key in .x and value in .y
    (`src/kernels/radix-sort/RadixSortTextureKernel.ts:27-29`): the capability
    is sorting packed records in an arbitrary 2-D layout; rows are linearized
    row-major exactly like the texture addressing (`src/shaders/RadixSort.ts:
    29-34`).
    """
    packed = jnp.asarray(packed)
    if packed.shape[-1] != 2:
        raise ValueError("packed records must have trailing dimension 2")
    lead_shape = packed.shape[:-1]
    flat = packed.reshape(-1, 2)
    k, v = sort(flat[:, 0], flat[:, 1], count=count, **kwargs)
    return jnp.stack([k, v], axis=-1).reshape(*lead_shape, 2)
