"""Multi-chip layer: distributed sort over `jax.sharding.Mesh`.

Two exchange strategies:
- :func:`mesh_sort` — bitonic compare-split network (fixed-size ppermute
  exchanges, log^2(D) rounds; best at small D)
- :func:`exchange_sort` — exact-splitter radix exchange (one ragged
  all-to-all; best at large D; skew-immune by rank-based splitting)

Plus the reference's other public op lifted to the mesh:
- :func:`mesh_prefix_sum` — per-shard scan + ONE tiny
  all_gather of shard totals (u32 wrap addition is associative)
- :func:`mesh_sort_segments` — ragged segmented sorts: distributed-scan
  segment ids + the composite (seg, key, idx) tuple over the
  compare-split network (`sort_segments(mesh=)` routes here)
- :func:`mesh_sort_batched` — per-row sorts with the batch dimension
  sharded: rows are independent, so this is the collective-free case
  (`sort_batched(mesh=)` routes here)
"""
from .batched import mesh_sort_batched
from .check import mesh_disorder_count, mesh_is_sorted
from .mesh_sort import mesh_sort, sharded
from .radix_exchange import exchange_sort
from .scan import mesh_prefix_sum
from .segmented import mesh_sort_segments

__all__ = [
    "mesh_sort",
    "exchange_sort",
    "mesh_prefix_sum",
    "mesh_is_sorted",
    "mesh_disorder_count",
    "mesh_sort_batched",
    "mesh_sort_segments",
    "sharded",
]
