"""Shared helpers for the sort engines: key transforms, padding, tiling math.

The reference sorts raw u32 bit patterns (its WGSL buffers are
``array<u32>`` regardless of the JS-side dtype, ``src/shaders/RadixSort.ts``);
these helpers centralize the dtype ↔ sortable-u32 mapping and the sentinel
padding that replaces the reference's ``ELEMENT_COUNT``/``LAST_THREAD``
partial-block masking (``src/shaders/RadixSort.ts:61-72``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Sentinel that sorts after every real key (ascending): all-ones.
SENTINEL_U32 = jnp.uint32(0xFFFFFFFF)

SUPPORTED_KEY_DTYPES = ("uint32", "float32", "int32")
# 64-bit key dtypes (extension past the reference, which is 32-bit-only —
# its WGSL buffers are array<u32>). Requires jax x64 mode for the input
# array itself; keys travel as (hi, lo) u32 column pairs, sorted with
# num_keys=2.
SUPPORTED_KEY_DTYPES_64 = ("uint64", "float64", "int64")
# 16-bit key dtypes (extension; float16/bfloat16 are the dtypes of model
# logits and activations). Keys are widened to their u16 bit pattern in a
# u32 lane.
SUPPORTED_KEY_DTYPES_16 = ("uint16", "int16", "float16", "bfloat16")


def is_16bit_key_dtype(dtype) -> bool:
    if dtype is None:
        return False
    return jnp.dtype(dtype).name in SUPPORTED_KEY_DTYPES_16


def native_key_bits(dtype) -> int:
    """Meaningful key-bit width of a supported dtype (16, 32 or 64) — the
    default and maximum `bit_count` for that dtype."""
    if is_16bit_key_dtype(dtype):
        return 16
    if is_64bit_key_dtype(dtype):
        return 64
    return 32


def _u16_pattern(keys: jax.Array) -> jax.Array:
    """16-bit dtype -> its u16 bit pattern, widened into a u32 lane."""
    return jax.lax.bitcast_convert_type(keys, jnp.uint16).astype(jnp.uint32)


def to_sortable_u32(keys: jax.Array) -> jax.Array:
    """Bitcast keys to the u32 bit pattern the reference orders by.

    uint32: identity. float32/int32: reinterpret bits (matches the reference,
    which is documented for non-negative floats only, ``README.md:9,68,95``).
    16-bit dtypes (uint16/int16/float16/bfloat16) widen their u16 bit
    pattern into the low half of a u32 lane (same contract, one width down).
    Use :func:`to_total_order_u32` for a true total order on signed values.
    """
    if keys.dtype == jnp.uint32:
        return keys
    if keys.dtype in (jnp.float32, jnp.int32):
        return jax.lax.bitcast_convert_type(keys, jnp.uint32)
    if is_16bit_key_dtype(keys.dtype):
        return _u16_pattern(keys)
    raise TypeError(
        f"unsupported key dtype {keys.dtype}; expected one of "
        f"{SUPPORTED_KEY_DTYPES + SUPPORTED_KEY_DTYPES_16}"
    )


def from_sortable_u32(u: jax.Array, dtype) -> jax.Array:
    if dtype == jnp.uint32:
        return u
    if is_16bit_key_dtype(dtype):
        return jax.lax.bitcast_convert_type(u.astype(jnp.uint16), dtype)
    return jax.lax.bitcast_convert_type(u, dtype)


def to_total_order_u32(keys: jax.Array) -> jax.Array:
    """Monotone bijection to u32 giving a *total* ascending order.

    Extension beyond the reference (which requires non-negative keys):
    float32 uses the sign-flip trick (flip all bits if negative, else flip
    sign bit); int32 offsets by 2^31. 16-bit dtypes apply the same mapping
    at 16-bit width, widened into the u32 lane (so masked `bit_count` and
    descending flips stay within the low 16 bits).
    """
    if keys.dtype == jnp.uint32:
        return keys
    if keys.dtype == jnp.int32:
        return jax.lax.bitcast_convert_type(keys, jnp.uint32) ^ jnp.uint32(0x80000000)
    if keys.dtype == jnp.float32:
        u = jax.lax.bitcast_convert_type(keys, jnp.uint32)
        flip = jnp.where(
            (u >> 31) == 1, jnp.uint32(0xFFFFFFFF), jnp.uint32(0x80000000)
        )
        return u ^ flip
    if keys.dtype == jnp.uint16:
        return keys.astype(jnp.uint32)
    if keys.dtype == jnp.int16:
        return _u16_pattern(keys) ^ jnp.uint32(0x8000)
    if keys.dtype in (jnp.float16, jnp.bfloat16):
        u = _u16_pattern(keys)
        flip = jnp.where(
            (u >> 15) == 1, jnp.uint32(0xFFFF), jnp.uint32(0x8000)
        )
        return u ^ flip
    raise TypeError(f"unsupported key dtype {keys.dtype}")


def from_total_order_u32(u: jax.Array, dtype) -> jax.Array:
    if dtype == jnp.uint32:
        return u
    if dtype == jnp.int32:
        return jax.lax.bitcast_convert_type(u ^ jnp.uint32(0x80000000), jnp.int32)
    if dtype == jnp.float32:
        flip = jnp.where((u >> 31) == 1, jnp.uint32(0x80000000), jnp.uint32(0xFFFFFFFF))
        return jax.lax.bitcast_convert_type(u ^ flip, jnp.float32)
    if dtype == jnp.uint16:
        return u.astype(jnp.uint16)
    if dtype == jnp.int16:
        return jax.lax.bitcast_convert_type(
            (u ^ jnp.uint32(0x8000)).astype(jnp.uint16), jnp.int16
        )
    if jnp.dtype(dtype) in (jnp.dtype(jnp.float16), jnp.dtype(jnp.bfloat16)):
        flip = jnp.where((u >> 15) == 1, jnp.uint32(0x8000), jnp.uint32(0xFFFF))
        return jax.lax.bitcast_convert_type(
            (u ^ flip).astype(jnp.uint16), dtype
        )
    raise TypeError(f"unsupported key dtype {dtype}")


def is_64bit_key_dtype(dtype) -> bool:
    if dtype is None:  # e.g. getattr(list_input, "dtype", None)
        return False
    return jnp.dtype(dtype).name in SUPPORTED_KEY_DTYPES_64


def guard_64bit_downcast(raw) -> None:
    """Raise if `raw` carries a 64-bit key dtype that `jnp.asarray` would
    silently truncate because jax x64 mode is off.

    Must run on the RAW input, before any asarray: with x64 disabled the
    downcast is silent (uint64 -> uint32 drops the hi word) and the sort
    would return wrong data with no error. A jnp array can only carry a
    64-bit dtype when x64 is on, so this fires exactly on host arrays.
    """
    dt = getattr(raw, "dtype", None)
    if is_64bit_key_dtype(dt) and not jax.config.jax_enable_x64:
        raise TypeError(
            f"keys have 64-bit dtype {dt} but jax x64 mode is disabled — "
            "jnp.asarray would silently truncate them to 32 bits. Enable "
            "it first: jax.config.update('jax_enable_x64', True)"
        )


def _split_u64(u):
    """u64 -> (hi, lo) u32 columns. Lexicographic (hi, lo) == u64 order."""
    hi = jax.lax.convert_element_type(u >> jnp.uint64(32), jnp.uint32)
    lo = jax.lax.convert_element_type(u & jnp.uint64(0xFFFFFFFF), jnp.uint32)
    return hi, lo


def _join_u64(hi, lo):
    h = jax.lax.convert_element_type(hi, jnp.uint64)
    l = jax.lax.convert_element_type(lo, jnp.uint64)
    return (h << jnp.uint64(32)) | l


def to_sortable_u64_cols(keys: jax.Array):
    """Bit-pattern order as (hi, lo) u32 columns (reference semantics lifted
    to 64 bits: float64/int64 ordered by their u64 bit pattern — correct for
    non-negative values, like the reference's float32 contract)."""
    if keys.dtype == jnp.uint64:
        return _split_u64(keys)
    if keys.dtype in (jnp.float64, jnp.int64):
        return _split_u64(jax.lax.bitcast_convert_type(keys, jnp.uint64))
    raise TypeError(
        f"unsupported key dtype {keys.dtype}; expected one of "
        f"{SUPPORTED_KEY_DTYPES_64}"
    )


def from_sortable_u64_cols(hi, lo, dtype):
    u = _join_u64(hi, lo)
    if dtype == jnp.uint64:
        return u
    return jax.lax.bitcast_convert_type(u, dtype)


def to_total_order_u64_cols(keys: jax.Array):
    """True total ascending order as (hi, lo) u32 columns: int64 by sign-bit
    offset, float64 by the sign-flip trick (same mapping as the 32-bit
    :func:`to_total_order_u32`, one word wider)."""
    if keys.dtype == jnp.uint64:
        return _split_u64(keys)
    if keys.dtype == jnp.int64:
        u = jax.lax.bitcast_convert_type(keys, jnp.uint64)
        return _split_u64(u ^ jnp.uint64(0x8000000000000000))
    if keys.dtype == jnp.float64:
        u = jax.lax.bitcast_convert_type(keys, jnp.uint64)
        flip = jnp.where(
            (u >> jnp.uint64(63)) == 1,
            jnp.uint64(0xFFFFFFFFFFFFFFFF),
            jnp.uint64(0x8000000000000000),
        )
        return _split_u64(u ^ flip)
    raise TypeError(f"unsupported key dtype {keys.dtype}")


def from_total_order_u64_cols(hi, lo, dtype):
    u = _join_u64(hi, lo)
    if dtype == jnp.uint64:
        return u
    if dtype == jnp.int64:
        return jax.lax.bitcast_convert_type(
            u ^ jnp.uint64(0x8000000000000000), jnp.int64
        )
    if dtype == jnp.float64:
        flip = jnp.where(
            (u >> jnp.uint64(63)) == 1,
            jnp.uint64(0x8000000000000000),
            jnp.uint64(0xFFFFFFFFFFFFFFFF),
        )
        return jax.lax.bitcast_convert_type(u ^ flip, jnp.float64)
    raise TypeError(f"unsupported key dtype {dtype}")


def guard_64bit_value_downcast(raw) -> None:
    """`guard_64bit_downcast` for the VALUE payload: refuse a silent
    uint64->uint32 truncation at asarray time when x64 mode is off."""
    dt = getattr(raw, "dtype", None)
    if is_64bit_key_dtype(dt) and not jax.config.jax_enable_x64:
        raise TypeError(
            f"values have 64-bit dtype {dt} but jax x64 mode is disabled — "
            "jnp.asarray would silently truncate them to 32 bits. Enable "
            "it first: jax.config.update('jax_enable_x64', True)"
        )


def validate_value_dtype(values) -> None:
    """Values ride the engines as u32 columns: one for 4-byte dtypes, an
    (hi, lo) pair for 8-byte dtypes (capability superset of the reference's
    u32-only payload buffers, `RadixSortBufferKernel.ts:34-36`)."""
    if values.dtype.itemsize not in (4, 8):
        raise TypeError(
            f"values must be a 32- or 64-bit dtype, got {values.dtype}"
        )


def values_to_u32_cols(values: jax.Array):
    """Payload -> tuple of u32 columns: (v,) for 4-byte dtypes, the (hi, lo)
    bit-pattern pair for 8-byte dtypes (which require jax x64 mode, like
    64-bit keys — use `guard_64bit_value_downcast` on the raw input)."""
    if values.dtype.itemsize == 4:
        return (jax.lax.bitcast_convert_type(values, jnp.uint32),)
    return _split_u64(jax.lax.bitcast_convert_type(values, jnp.uint64))


def values_from_u32_cols(cols, dtype):
    """Inverse of :func:`values_to_u32_cols` (cols are the sorted columns)."""
    if len(cols) == 1:
        return jax.lax.bitcast_convert_type(cols[0], dtype)
    return jax.lax.bitcast_convert_type(_join_u64(cols[0], cols[1]), dtype)


def bit_mask_cols(bit_count: int):
    """(hi, lo) u32 masks selecting the low `bit_count` of 64 key bits."""
    lo = jnp.uint32(0xFFFFFFFF) if bit_count >= 32 else bit_mask(bit_count)
    hi = bit_mask(bit_count - 32) if bit_count > 32 else jnp.uint32(0)
    return hi, lo


def validate_bit_count_64(bit_count: int) -> None:
    # 64-bit keys extend the reference constraint to [4, 64]
    if not (4 <= bit_count <= 64) or bit_count % 4 != 0:
        raise ValueError(
            f"bit_count must be a multiple of 4 in [4, 64] for 64-bit keys, "
            f"got {bit_count}"
        )


def bit_mask(bit_count: int) -> jnp.uint32:
    if bit_count == 32:
        return jnp.uint32(0xFFFFFFFF)
    return jnp.uint32((1 << bit_count) - 1)


def validate_bit_count(bit_count: int) -> None:
    # reference constraint: multiple of 4 in [4, 32] (README.md:97)
    if not (4 <= bit_count <= 32) or bit_count % 4 != 0:
        raise ValueError(f"bit_count must be a multiple of 4 in [4, 32], got {bit_count}")


def validate_bit_count_for(dtype, bit_count: int) -> None:
    """`bit_count` range check scaled to the key dtype's native width
    (16-bit keys: [4, 16]; 32-bit: the reference's [4, 32]; 64-bit: [4, 64])."""
    w = native_key_bits(dtype)
    if w == 64:
        validate_bit_count_64(bit_count)
    elif not (4 <= bit_count <= w) or bit_count % 4 != 0:
        raise ValueError(
            f"bit_count must be a multiple of 4 in [4, {w}] for "
            f"{jnp.dtype(dtype).name} keys, got {bit_count}"
        )


def lex_lt(a_cols, b_cols):
    """Elementwise lexicographic `a < b` over parallel column tuples (the
    leading column decides; later columns break ties)."""
    lt = a_cols[-1] < b_cols[-1]
    for a, b in zip(reversed(a_cols[:-1]), reversed(b_cols[:-1])):
        lt = (a < b) | ((a == b) & lt)
    return lt


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def pad_to(x: jax.Array, n: int, fill) -> jax.Array:
    """Pad 1-D array to length n with fill (no-op if already length n)."""
    if x.shape[0] == n:
        return x
    return jnp.concatenate([x, jnp.full((n - x.shape[0],), fill, dtype=x.dtype)])
