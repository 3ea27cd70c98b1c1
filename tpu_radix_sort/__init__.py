"""tpu_radix_sort — a sort-execution engine in JAX.

The full capability surface of the WebGPU 4-way radix sort reference
(MatthieuLepers/WebGPU-Radix-Sort) as JAX operations: stable key and
key+value sorts through `jax.lax.sort` (which XLA lowers to CUB's radix
sort on a GPU where the operand tuple allows), prefix scans, `lax.cond`
early exits, batched and segmented sorts, and `shard_map` sorts across
device meshes. See SURVEY.md for the reference analysis and DESIGN.md for
the architecture.
"""
from .api import (
    PrefixSumKernel,
    RadixSortBufferKernel,
    RadixSortKernel,
    RadixSortPackedKernel,
    RadixSortTextureKernel,
)
from .ops.batched import argsort_batched, sort_batched
from .ops.checksort import disorder_count, is_sorted
from .ops.scan import prefix_sum
from .ops.segmented import argsort_segments, sort_segments
from .ops.sort import argsort, sort, sort_packed
from .parallel import exchange_sort, mesh_sort

__version__ = "0.1.0"

__all__ = [
    "sort",
    "argsort",
    "sort_batched",
    "argsort_batched",
    "sort_segments",
    "argsort_segments",
    "sort_packed",
    "mesh_sort",
    "exchange_sort",
    "prefix_sum",
    "is_sorted",
    "disorder_count",
    "RadixSortKernel",
    "RadixSortBufferKernel",
    "RadixSortPackedKernel",
    "RadixSortTextureKernel",
    "PrefixSumKernel",
    "__version__",
]
