"""Golden model: the reference's sort semantics, in NumPy.

This is the byte-exact oracle every engine in this package is tested against.
It reproduces, without any device code, exactly what the reference's WGSL
pipeline computes:

- stable ascending LSD radix sort of the first ``count`` elements of the key
  buffer (reference ``README.md:94`` — "elements are sorted in ascending
  order"; LSD with per-pass stable ranks ⇒ overall stable,
  ``src/shaders/RadixSort.ts:122-125`` + ``RadixSortReorder.ts:97-101``)
- ordering key is the low ``bit_count`` bits only: passes run
  ``CURRENT_BIT = 0, 2, .., bit_count-2`` and extract
  ``(key >> CURRENT_BIT) & 0x3`` (``AbstractRadixSortKernel.ts:94-107``,
  ``src/shaders/RadixSort.ts:61-62``), so high bits never participate
- elements past ``count`` are untouched (sub-count sorts,
  ``example/tests.ts:31,56``)
- float32 keys are ordered by their uint32 bit pattern (the shaders
  reinterpret storage as ``array<u32>`` regardless; correct for non-negative
  floats, ``README.md:9,68,95``)
- the optional value payload is permuted identically to the keys
  (``src/shaders/RadixSortReorder.ts:101``)

Because the full sort is stable, the output is a pure function of the input
and does not depend on the reference's pass structure (2-bit digits,
workgroup size) — which its own test matrix asserts by sweeping workgroup
shapes (``example/tests.ts:19-28``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["golden_sort", "golden_prefix_sum", "golden_is_sorted"]


def _bit_pattern_u32(keys: np.ndarray) -> np.ndarray:
    """Map keys to the uint32 bit pattern the reference sorts by."""
    keys = np.asarray(keys)
    if keys.dtype == np.uint32:
        return keys
    if keys.dtype in (np.float32, np.int32):
        return keys.view(np.uint32)
    raise TypeError(f"unsupported key dtype {keys.dtype}; expected uint32/float32/int32")


def _bit_pattern_u64(keys: np.ndarray) -> np.ndarray:
    """64-bit keys' sorted-by bit pattern (repo extension: reference
    semantics — order by the raw bit pattern — lifted one word wider)."""
    keys = np.asarray(keys)
    if keys.dtype == np.uint64:
        return keys
    return keys.view(np.uint64)


def _is_64bit(keys: np.ndarray) -> bool:
    return np.asarray(keys).dtype in (np.uint64, np.int64, np.float64)


def _is_16bit(keys: np.ndarray) -> bool:
    """16-bit key dtypes (repo extension): uint16/int16/float16, plus
    bfloat16 via ml_dtypes (numpy sees it as a 2-byte 'V'-kind scalar)."""
    dt = np.asarray(keys).dtype
    return dt.itemsize == 2 and (
        dt.kind in "uif" or dt.name == "bfloat16"
    )


def _bit_pattern_u16_widened(keys: np.ndarray) -> np.ndarray:
    """16-bit keys' u16 bit pattern, widened to u32 (the check/sort view)."""
    return np.asarray(keys).view(np.uint16).astype(np.uint32)


def _total_order_u16_widened(keys: np.ndarray) -> np.ndarray:
    """NumPy mirror of the 16-bit branch of ``common.to_total_order_u32``."""
    keys = np.asarray(keys)
    u = _bit_pattern_u16_widened(keys)
    if keys.dtype.kind == "u":
        return u
    if keys.dtype.kind == "i":
        return u ^ np.uint32(0x8000)
    # float16 / bfloat16: sign bit at 15 either way
    flip = np.where(
        (u >> np.uint32(15)) == 1, np.uint32(0xFFFF), np.uint32(0x8000)
    )
    return u ^ flip


def golden_sort(
    keys: np.ndarray,
    values: np.ndarray | None = None,
    *,
    count: int | None = None,
    bit_count: int | None = None,
    descending: bool = False,
    total_order: bool = False,
):
    """Reference-semantics sort. Returns (keys, values) or keys if values is None.

    `descending` is this repo's extension (the reference is ascending-only):
    stable descending = stable ascending of the bit-flipped masked key.
    `total_order` (extension) orders signed and negative keys numerically:
    keys map through the same monotone bijection as the sort's
    `total_order=True` before masking.
    """
    keys = np.asarray(keys)
    if keys.ndim != 1:
        raise ValueError("keys must be 1-D")
    n = keys.shape[0] if count is None else int(count)
    if not (0 <= n <= keys.shape[0]):
        raise ValueError(f"count {n} out of range for buffer of {keys.shape[0]}")
    wide = _is_64bit(keys)
    hi_bit = 64 if wide else (16 if _is_16bit(keys) else 32)
    if bit_count is None:
        bit_count = hi_bit  # default follows the key width (like trs.sort)
    if not (4 <= bit_count <= hi_bit) or bit_count % 4 != 0:
        # reference: bit_count must be a multiple of 4 in [4, 32]
        # (README.md:97); 64-bit keys extend the range to [4, 64],
        # 16-bit keys cap it at [4, 16]
        raise ValueError(f"bit_count must be a multiple of 4 in [4, {hi_bit}]")

    if wide:
        u = _total_order_u64(keys) if total_order else _bit_pattern_u64(keys)
        mask = (
            np.uint64(0xFFFFFFFFFFFFFFFF)
            if bit_count == 64
            else np.uint64((1 << bit_count) - 1)
        )
    else:
        if hi_bit == 16:
            u = (_total_order_u16_widened(keys) if total_order
                 else _bit_pattern_u16_widened(keys))
        else:
            u = _total_order_u32(keys) if total_order else _bit_pattern_u32(keys)
        mask = (
            np.uint32(0xFFFFFFFF)
            if bit_count == 32
            else np.uint32((1 << bit_count) - 1)
        )
    mk = u[:n] & mask
    if descending:
        mk = mk ^ mask
    order = np.argsort(mk, kind="stable")

    out_keys = keys.copy()
    out_keys[:n] = keys[:n][order]
    if values is None:
        return out_keys
    values = np.asarray(values)
    if values.shape[0] < n:
        raise ValueError("values buffer shorter than count")
    out_values = values.copy()
    out_values[:n] = values[:n][order]
    return out_keys, out_values


def golden_prefix_sum(items: np.ndarray, *, count: int | None = None) -> np.ndarray:
    """Reference-semantics exclusive prefix sum (in-place over first count).

    The reference's PrefixSumKernel computes a work-efficient *exclusive* scan
    over a u32 buffer, in place, with u32 wraparound
    (``src/shaders/PrefixSum.ts:13-79``; oracle ``example/tests.ts:288-296``).
    """
    items = np.asarray(items)
    n = items.shape[0] if count is None else int(count)
    out = items.copy()
    # u32 cumsum wraps mod 2^32 exactly like the reference's u32 adds (no
    # float promotion anywhere, so sums past 2^53 stay exact)
    inc = np.cumsum(items[:n].view(np.uint32), dtype=np.uint32)
    excl = np.zeros(n, np.uint32)
    excl[1:] = inc[:-1]
    out[:n] = excl.view(items.dtype)
    return out


def _total_order_u32(keys: np.ndarray) -> np.ndarray:
    """NumPy mirror of ``ops/common.to_total_order_u32`` (true total order
    for signed/negative values — repo extension past the reference)."""
    keys = np.asarray(keys)
    if keys.dtype == np.uint32:
        return keys
    if keys.dtype == np.int32:
        return keys.view(np.uint32) ^ np.uint32(0x80000000)
    if keys.dtype == np.float32:
        u = keys.view(np.uint32)
        flip = np.where(
            (u >> np.uint32(31)) == 1,
            np.uint32(0xFFFFFFFF), np.uint32(0x80000000),
        )
        return u ^ flip
    raise TypeError(f"unsupported key dtype {keys.dtype}")


def _total_order_u64(keys: np.ndarray) -> np.ndarray:
    """NumPy mirror of ``ops/common.to_total_order_u64_cols`` (joined)."""
    keys = np.asarray(keys)
    if keys.dtype == np.uint64:
        return keys
    if keys.dtype == np.int64:
        return keys.view(np.uint64) ^ np.uint64(0x8000000000000000)
    if keys.dtype == np.float64:
        u = keys.view(np.uint64)
        flip = np.where(
            (u >> np.uint64(63)) == 1,
            np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64(0x8000000000000000),
        )
        return u ^ flip
    raise TypeError(f"unsupported key dtype {keys.dtype}")


def golden_is_sorted(keys: np.ndarray, *, count: int | None = None,
                     bit_count: int | None = None,
                     total_order: bool = False,
                     descending: bool = False) -> bool:
    """Adjacent-pair order check over the sorted-by key view.

    Mirrors the check-sort reduction: disorder = sum of (k[i] > k[i+1])
    (``src/shaders/CheckSort.ts:102-113``). 64-bit key dtypes check the
    u64 bit pattern (bit_count then defaults to 64). `total_order` /
    `descending` check under the correspondingly-flagged sort's key view
    (bijection, mask, then flip — exactly the sort's mkeys pipeline).
    """
    keys = np.asarray(keys)
    n = keys.shape[0] if count is None else int(count)
    if _is_64bit(keys):
        bit_count = 64 if bit_count is None else bit_count
        u = (_total_order_u64(keys) if total_order
             else _bit_pattern_u64(keys))[:n]
        mask = (
            np.uint64(0xFFFFFFFFFFFFFFFF)
            if bit_count == 64
            else np.uint64((1 << bit_count) - 1)
        )
    elif _is_16bit(keys):
        bit_count = 16 if bit_count is None else bit_count
        u = (_total_order_u16_widened(keys) if total_order
             else _bit_pattern_u16_widened(keys))[:n]
        mask = np.uint32((1 << bit_count) - 1)
    else:
        bit_count = 32 if bit_count is None else bit_count
        u = (_total_order_u32(keys) if total_order
             else _bit_pattern_u32(keys))[:n]
        mask = (
            np.uint32(0xFFFFFFFF)
            if bit_count == 32
            else np.uint32((1 << bit_count) - 1)
        )
    u = u & mask
    if descending:
        u = u ^ mask
    return bool(np.all(u[:-1] <= u[1:])) if n > 1 else True
