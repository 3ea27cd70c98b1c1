"""Construct-once / dispatch-many kernel classes.

The reference compiles every pipeline eagerly in the kernel constructor and
keeps `dispatch()` cheap (`src/kernels/radix-sort/AbstractRadixSortKernel.ts:
80-108`, SURVEY.md idiom 1). The JAX analogue: the constructor builds and
(optionally ahead-of-time) compiles one jitted callable specialized on the
static configuration (count, bit_count, dtypes, flags); `dispatch()` just
calls it. One class instance == one compiled pipeline chain, exactly like one
reference kernel instance == one set of GPUComputePipelines.

Class names mirror the reference exports (`src/index.ts:1-3`):
`RadixSortKernel` (+ alias `RadixSortBufferKernel`), `RadixSortPackedKernel`
(+ alias `RadixSortTextureKernel` — see ops.sort.sort_packed for the layout
mapping), `PrefixSumKernel`.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .ops import common
from .ops import scan as scan_ops
from .ops import sort as sort_ops

__all__ = [
    "RadixSortKernel",
    "RadixSortBufferKernel",
    "RadixSortPackedKernel",
    "RadixSortTextureKernel",
    "PrefixSumKernel",
]


class RadixSortKernel:
    """Sorts `count` leading elements of a key (and optional value) buffer.

    Options mirror the reference constructor
    (`RadixSortBufferKernel.ts:14-23`): count, bit_count, check_order; plus
    the extensions (method, total_order, descending, key/value dtypes, and
    `mesh=` — one constructed instance as a distributed pipeline over a
    `jax.sharding.Mesh` axis, see ops/sort.py routing). `local_shuffle` and
    `avoid_bank_conflicts` are accepted for API compatibility and ignored:
    both are WGSL micro-optimizations that the reference itself measures as
    no-ops and ships disabled (`README.md:124-129,162-168`); the engine here
    is XLA's sort, which lays out its own shared memory.
    """

    def __init__(
        self,
        *,
        count: int,
        has_values: bool = False,
        bit_count: int | None = None,
        check_order: bool = False,
        total_order: bool = False,
        descending: bool = False,
        key_dtype=jnp.uint32,
        value_dtype=jnp.uint32,
        method: str = "auto",
        local_shuffle: bool = False,
        avoid_bank_conflicts: bool = False,
        mesh=None,
        axis_name: str = "x",
    ):
        # bit_count defaults to the key width; 64-bit key dtypes extend the
        # range to [4, 64] (ops/sort64.py) and need jax x64 mode at
        # dispatch/compile time so the input dtype survives
        wide = common.is_64bit_key_dtype(key_dtype)
        if bit_count is None:
            bit_count = 64 if wide else 32
        if wide:
            common.validate_bit_count_64(bit_count)
        else:
            common.validate_bit_count(bit_count)
        del local_shuffle, avoid_bank_conflicts  # accepted, ignored (see docstring)
        self.count = int(count)
        self.has_values = bool(has_values)
        self.bit_count = int(bit_count)
        self.check_order = bool(check_order)
        self.key_dtype = jnp.dtype(key_dtype)
        self.value_dtype = jnp.dtype(value_dtype)
        self.method = method
        self.mesh = mesh
        self.axis_name = axis_name

        kwargs = dict(
            count=self.count,
            bit_count=self.bit_count,
            check_order=self.check_order,
            total_order=total_order,
            descending=descending,
            method=method,
            # mesh= makes this one constructed instance a DISTRIBUTED
            # pipeline (routing in ops/sort.py) — same construct-once/
            # dispatch-many contract, over a jax.sharding.Mesh axis
            mesh=mesh,
            axis_name=axis_name,
        )
        if self.has_values:
            self._fn = jax.jit(lambda k, v: sort_ops.sort(k, v, **kwargs))
        else:
            self._fn = jax.jit(lambda k: sort_ops.sort(k, **kwargs))

    def dispatch(self, keys, values=None):
        """Run the compiled sort. Returns keys or (keys, values)."""
        if self.has_values:
            if values is None:
                raise ValueError("kernel was built with has_values=True")
            return self._fn(keys, values)
        if values is not None:
            raise ValueError("kernel was built with has_values=False")
        return self._fn(keys)

    def compile(self, buffer_len=None):
        """Ahead-of-time compile for a given buffer length (defaults to count).

        With `mesh=`, the input avals carry the shard-along-axis sharding
        (the layout dispatch expects), so the AOT executable is the real
        distributed pipeline, collectives included.
        """
        n = buffer_len or self.count
        sharding = None
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            sharding = NamedSharding(self.mesh, PartitionSpec(self.axis_name))
        k = jax.ShapeDtypeStruct((n,), self.key_dtype, sharding=sharding)
        if self.has_values:
            v = jax.ShapeDtypeStruct((n,), self.value_dtype, sharding=sharding)
            return self._fn.lower(k, v).compile()
        return self._fn.lower(k).compile()


RadixSortBufferKernel = RadixSortKernel


class RadixSortPackedKernel:
    """Sorts packed (key, value) records laid out as [..., 2] u32 arrays.

    Capability-parity port of the reference's texture kernel (rg32uint
    texels, key in .x / value in .y, row-major linearization —
    `RadixSortTextureKernel.ts:27-29`, `src/shaders/RadixSort.ts:29-34`).
    """

    def __init__(self, *, count: int, bit_count: int = 32, check_order: bool = False,
                 method: str = "auto"):
        common.validate_bit_count(bit_count)
        self.count = int(count)
        self._fn = jax.jit(
            functools.partial(
                sort_ops.sort_packed,
                count=self.count,
                bit_count=bit_count,
                check_order=check_order,
                method=method,
            )
        )

    def dispatch(self, packed):
        return self._fn(packed)


RadixSortTextureKernel = RadixSortPackedKernel


class PrefixSumKernel:
    """Work-efficient exclusive prefix sum over a u32 buffer (public op).

    Reference: `PrefixSumKernel` (`src/kernels/PrefixSumKernel.ts`),
    exclusive, in place over the first `count` elements. Like the sort
    kernel, `avoid_bank_conflicts` is accepted for API compatibility and
    ignored (the reference ships it disabled and measures no effect,
    `README.md:162-168`).
    """

    def __init__(self, *, count: int, inclusive: bool = False,
                 avoid_bank_conflicts: bool = False, mesh=None,
                 axis_name: str = "x"):
        del avoid_bank_conflicts  # accepted, ignored (see docstring)
        self.count = int(count)
        self._fn = jax.jit(
            functools.partial(
                scan_ops.prefix_sum,
                count=self.count,
                inclusive=inclusive,
                # mesh= = distributed scan (parallel/scan.py), same
                # construct-once contract as RadixSortKernel(mesh=)
                mesh=mesh,
                axis_name=axis_name,
            )
        )

    def dispatch(self, items):
        return self._fn(items)
