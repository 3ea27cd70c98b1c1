"""Distributed sort over a JAX device mesh (shard_map + collectives).

The reference is single-GPU (browser, one ``GPUDevice``) — there is no
counterpart to cite; this layer is the new subsystem SURVEY.md §2.4/§7 calls
for: scaling element count past one device instead of past one workgroup
(the reference's recursion/2-D-dispatch tricks, ``src/utils.ts:8-23``).

Algorithm: **bitonic compare-split** over the mesh axis.

1. Each shard sorts its local block (`jax.lax.sort` on the column tuple
   (key column(s), global index), so the order is total and stable).
2. Run a bitonic sorting network over the D shard ids where each
   compare-exchange is a *compare-split*: the paired shards exchange their
   full blocks (a fixed-size `ppermute`), the lower side keeps the L
   smallest of the 2L union, the upper side the L largest, and each
   re-sorts locally. Because both blocks are ascending, the min/max halves
   are elementwise ``min/max(x_i, reverse(y)_i)`` (one pass), and the local
   re-sort restores ascending order.

Properties:

- every exchange is the full fixed-size block → static shapes, no ragged
  all-to-all, immune to key skew (a Zipf-hot bucket changes nothing);
- stability and shard-shape invariance come from the (key, index)
  tie-break.

Cost: bitonic on D shards is log2(D)·(log2(D)+1)/2 compare-splits, each
moving L elements per shard plus one local re-sort. The radix-exchange
layer (`radix_exchange.py`) moves each element once and is the complement
for larger D.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import common

# per-shard padded lengths are powers of two of at least this many elements
MIN_SHARD_LEN = 128


def _local_sort(arrs, nk):
    """Sort a shard's column tuple by its leading `nk` columns. The tuple
    (key column(s), unique global index) is a total order, so no stability
    flag is needed."""
    return tuple(jax.lax.sort(tuple(arrs), num_keys=nk, is_stable=False))


def _compare_split_ce(arrs, recv, keep_min, nk):
    """Elementwise compare-split decision: keep min or max of each pair.

    `recv` must already be the partner block reversed (rank r paired with
    rank L-1-r). The leading `nk` arrays are the compare tuple (key
    column(s) + the unique tie index — 64-bit keys contribute two columns),
    so lexicographic `<` is a total order and the two sides keep
    complementary elements.
    """
    mine_lt = common.lex_lt(arrs[:nk], recv[:nk])
    take_mine = jnp.where(keep_min, mine_lt, ~mine_lt)
    return tuple(jnp.where(take_mine, a, r) for a, r in zip(arrs, recv))


def _exchange_and_ce(arrs, perm, axis_name, keep_min, overlap_chunks, nk):
    """One compare-split exchange, optionally chunked for comm/compute overlap.

    With ``overlap_chunks == S > 1`` the block is exchanged in S sub-chunks
    and the `ppermute` for chunk c+1 is issued *before* the compare-select
    of chunk c — a software pipeline whose independent collective-permutes
    XLA's async scheduler can overlap with the selects (SURVEY.md §7
    overlap groundwork; the byte-identical S == 1 path is the reference
    behavior). My chunk c pairs with the partner's
    chunk S-1-c reversed: global position p pairs with L-1-p.
    """
    if overlap_chunks <= 1:
        recv = tuple(jax.lax.ppermute(a, axis_name, perm) for a in arrs)
        recv = tuple(r[::-1] for r in recv)
        return _compare_split_ce(arrs, recv, keep_min, nk)

    L = arrs[0].shape[0]
    S = overlap_chunks
    if L % S != 0:
        raise ValueError(f"overlap_chunks {S} must divide shard length {L}")
    Lc = L // S
    chunks = [tuple(a[c * Lc:(c + 1) * Lc] for a in arrs) for c in range(S)]

    def send(c):
        # partner chunk for my chunk c is its chunk S-1-c
        return tuple(
            jax.lax.ppermute(a, axis_name, perm) for a in chunks[S - 1 - c]
        )

    out = [None] * S
    pending = send(0)
    for c in range(S):
        nxt = send(c + 1) if c + 1 < S else None
        recv = tuple(r[::-1] for r in pending)
        out[c] = _compare_split_ce(chunks[c], recv, keep_min, nk)
        pending = nxt
    return tuple(
        jnp.concatenate([out[c][a] for c in range(S)])
        for a in range(len(arrs))
    )


def _compare_split_network(arrs, axis_name, n_dev, *, overlap_chunks=1,
                           nk=2):
    """Bitonic sorting network over shard ids with compare-split exchanges.

    arrs: tuple of (L,) u32 arrays whose leading `nk` columns are the
    lexicographic compare tuple (key column(s), then a unique tie-break
    index), all locally ascending-sorted by that tuple. Returns the tuple
    globally sorted in shard-major order.
    """
    me = jax.lax.axis_index(axis_name)
    k = 2
    while k <= n_dev:
        j = k // 2
        while j >= 1:
            perm = [(i, i ^ j) for i in range(n_dev)]
            # bitonic direction rule on shard ids: ascending region when
            # (me & k) == 0; the lower-index side of the pair keeps the mins.
            keep_min = ((me & j) == 0) == ((me & k) == 0)
            half = _exchange_and_ce(
                arrs, perm, axis_name, keep_min, overlap_chunks, nk
            )
            arrs = _local_sort(half, nk)
            j //= 2
        k *= 2
    return arrs


def _shard_sort(arrs, *, axis_name, n_dev, overlap_chunks=1, nk=2):
    arrs = _local_sort(arrs, nk)
    if n_dev > 1:
        arrs = _compare_split_network(
            arrs, axis_name, n_dev, overlap_chunks=overlap_chunks, nk=nk,
        )
    return arrs


def mesh_sort(
    keys,
    values=None,
    *,
    mesh: Mesh,
    axis_name: str = "x",
    count=None,
    bit_count: int | None = None,
    check_order: bool = False,
    total_order: bool = False,
    descending: bool = False,
    overlap_chunks: int = 1,
):
    """Stable ascending sort of `keys` (and optional `values`) across a mesh.

    Semantics match the single-chip :func:`tpu_radix_sort.sort` (and hence
    the reference's option surface): first `count` elements sorted, suffix
    untouched, `bit_count` low bits ordered, stable, optional stable
    `descending` (ascending sort of the flipped masked key).

    ``check_order=True`` lifts the reference's early exit
    (`src/shaders/CheckSort.ts:139-145`) to the mesh: per-shard fast-gated
    checks + boundary pairs combine in one psum, and a globally-sorted
    input skips the whole compare-split network (see ``parallel/check.py``).
    The passthrough is byte-exact because a sorted input is a fixed point
    of the stable sort.

    `keys`/`values` are global 1-D arrays; shard them along `axis_name`
    (``NamedSharding(mesh, P(axis_name))``).
    Returns sorted keys, or (keys, values).

    ``overlap_chunks=S > 1`` pipelines each compare-split exchange in S
    sub-chunks so transfers overlap the compare-selects (output is
    byte-identical to S == 1; S must divide the padded per-shard length).
    """
    common.guard_64bit_downcast(keys)
    keys = jnp.asarray(keys)
    if keys.ndim != 1:
        raise ValueError("keys must be 1-D")
    wide = common.is_64bit_key_dtype(keys.dtype)
    if wide:
        bit_count = 64 if bit_count is None else bit_count
        common.validate_bit_count_64(bit_count)
    else:
        if bit_count is None:
            bit_count = common.native_key_bits(keys.dtype)
        common.validate_bit_count_for(keys.dtype, bit_count)
    n = keys.shape[0]
    count = n if count is None else int(count)
    if not (0 <= count <= n):
        raise ValueError(f"count {count} out of range for buffer of {n}")
    if values is not None:
        common.guard_64bit_value_downcast(values)
        values = jnp.asarray(values)
        if values.shape != keys.shape:
            raise ValueError("values must match keys shape")
        common.validate_value_dtype(values)
    n_dev = mesh.shape[axis_name]

    if count <= 1:
        return keys if values is None else (keys, values)

    # per-shard padded length: a power of two covering count/n_dev
    per = max(MIN_SHARD_LEN, common.next_pow2(common.cdiv(count, n_dev)))
    n_pad = per * n_dev
    if overlap_chunks > 1 and per % overlap_chunks != 0:
        raise ValueError(
            f"overlap_chunks {overlap_chunks} must divide the padded "
            f"per-shard length {per}"
        )

    return _mesh_sort_core(
        keys, values, mesh=mesh, axis_name=axis_name, count=count,
        bit_count=bit_count, check_order=check_order,
        total_order=total_order, descending=descending,
        overlap_chunks=overlap_chunks,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis_name", "count", "bit_count",
                     "check_order", "total_order", "descending",
                     "overlap_chunks"),
)
def _mesh_sort_core(keys, values, *, mesh, axis_name, count, bit_count,
                    check_order, total_order, descending, overlap_chunks):
    """Jitted body of :func:`mesh_sort` (inputs already validated); one
    compiled program per static configuration."""
    wide = common.is_64bit_key_dtype(keys.dtype)
    n = keys.shape[0]
    n_dev = mesh.shape[axis_name]
    per = max(MIN_SHARD_LEN, common.next_pow2(common.cdiv(count, n_dev)))
    n_pad = per * n_dev

    # key columns: one for 32-bit dtypes, (hi, lo) for 64-bit (a
    # lexicographic column tuple); masked + desc flips per column, exactly
    # like the single-chip paths
    if wide:
        if total_order:
            full_cols = common.to_total_order_u64_cols(keys[:count])
        else:
            full_cols = common.to_sortable_u64_cols(keys[:count])
        masks = common.bit_mask_cols(bit_count)
        masked = bit_count < 64
        lo_only = bit_count <= 32  # hi column all-zero after masking
        mcols = tuple(c & m for c, m in zip(full_cols, masks))
        if descending:
            mcols = tuple(c ^ m for c, m in zip(mcols, masks))
        key_cols = (mcols[1],) if lo_only else mcols
    else:
        if total_order:
            full_cols = (common.to_total_order_u32(keys[:count]),)
        else:
            full_cols = (common.to_sortable_u32(keys[:count]),)
        masked = bit_count < common.native_key_bits(keys.dtype)
        mkeys = full_cols[0] & common.bit_mask(bit_count)
        if descending:
            mkeys = mkeys ^ common.bit_mask(bit_count)
        key_cols = (mkeys,)

    mk_cols = tuple(
        common.pad_to(c, n_pad, common.SENTINEL_U32) for c in key_cols
    )
    idx = jnp.arange(n_pad, dtype=jnp.uint32)
    arrs = [*mk_cols, idx]
    nk = len(mk_cols) + 1
    carry_full = masked or descending
    if carry_full:
        # carry the original full key column(s) for output recovery (masked
        # keys drop high bits; descending keys are bit-flipped)
        arrs += [
            common.pad_to(c, n_pad, common.SENTINEL_U32) for c in full_cols
        ]
    vcols = ()
    if values is not None:
        # 8-byte value dtypes ride as an (hi, lo) u32 column pair
        vcols = common.values_to_u32_cols(values[:count])
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
    if check_order:
        from . import check

        ok = check.global_is_sorted(
            mk_cols, mesh=mesh, axis_name=axis_name, n_dev=n_dev,
        )
        out = jax.lax.cond(
            ok, lambda: tuple(arrs), lambda: fn(tuple(arrs))
        )
    else:
        out = fn(tuple(arrs))

    n_full = len(full_cols)
    if carry_full:
        sorted_cols = out[nk: nk + n_full]
    elif wide:
        # not masked => bit_count == 64 => both columns in the tuple
        sorted_cols = out[:n_full]
    else:
        sorted_cols = out[:1]
    sorted_cols = tuple(c[:count] for c in sorted_cols)
    if wide:
        s_hi, s_lo = sorted_cols
        if total_order:
            out_keys = common.from_total_order_u64_cols(s_hi, s_lo, keys.dtype)
        else:
            out_keys = common.from_sortable_u64_cols(s_hi, s_lo, keys.dtype)
    else:
        u_sorted = sorted_cols[0]
        if total_order:
            out_keys = common.from_total_order_u32(u_sorted, keys.dtype)
        else:
            out_keys = common.from_sortable_u32(u_sorted, keys.dtype)
    if count < n:
        out_keys = jnp.concatenate([out_keys, keys[count:]])
    if values is None:
        return out_keys
    vbase = (nk + n_full) if carry_full else nk
    v_sorted = tuple(c[:count] for c in out[vbase: vbase + len(vcols)])
    out_values = common.values_from_u32_cols(v_sorted, values.dtype)
    if count < n:
        out_values = jnp.concatenate([out_values, values[count:]])
    return out_keys, out_values


def sharded(mesh: Mesh, axis_name: str, x):
    """Place a global array with shard-along-axis sharding (helper)."""
    return jax.device_put(x, NamedSharding(mesh, P(axis_name)))
