"""Distributed sort via exact-splitter radix exchange (single all-to-all).

This is the SURVEY.md §7 "radix partitioning across a mesh" subsystem (no
reference counterpart — the reference is single-GPU): keys are partitioned
across shards by exact global-rank boundaries and exchanged once, instead of
the log^2(D) full-data rounds of `mesh_sort`'s compare-split network.

Phases (all inside one `shard_map`, all static-shape):

1. **Local sort** by (key, global index) — `jax.lax.sort`.
2. **Exact splitter selection.** The boundary between shards d-1 and d is
   the (key, idx) pair of global rank d*L. Because (key, idx) pairs are
   distinct, rank boundaries are exact points even under adversarial key
   skew (a Zipf hot bucket or all-equal keys change nothing) — this is the
   "hot-bucket skew handling": balance comes from ranks, not key values.
   Selection = 2 rounds (4 for 64-bit keys, over the joined u64 domain)
   of 2^16-way multi-probe key bisection (one `psum`
   each, all D-1 boundaries simultaneously) + a closed-form distribution
   of key ties over shards from one tiny all_gather — ties need no search
   because the idx tie-break is the contiguously-sharded global iota, so
   idx order among ties IS shard order (see `_select_splits`).
3. **One ragged all-to-all** (`jax.lax.ragged_all_to_all`): shard s sends
   its elements in [B_d, B_{d+1}) to shard d. Send layout is contiguous
   (data is sorted), receive sizes come from an all-gathered D x D size
   matrix, and every shard receives EXACTLY L elements — rank ranges tile
   the array. Payloads ride the same metadata.
4. **Local re-sort** of the L received elements, which arrive as D sorted
   runs laid out contiguously in source order.

Communication: one data exchange + 2 probe-count psums + two small
all_gathers ((D,2,D-1) tie counts and the (D,D) size matrix) — vs
compare-split's log2(D)(log2(D)+1)/2 full-data exchanges.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import common
from .mesh_sort import MIN_SHARD_LEN, _local_sort


def _probe_log2(n_dev):
    """Probes-per-round exponent k for the key bisection: key_bits/k psum
    rounds of (D-1)*2^k u32 counts each. k=16 (2 rounds at 32-bit, 4 at
    64-bit) while the payload stays under ~16 MB; k=8 at large D."""
    return 16 if (n_dev - 1) << 16 <= 1 << 22 else 8


def _select_splits(sk, targets, *, axis_name, n_dev):
    """Per-shard local split positions for each global-rank target — exact
    under any key skew, in O(1) collective rounds.

    sk: this shard's (L,) keys sorted ascending (by (key, idx); the idx
    tie-break is implicit, see below), as u32 — or u64 for wide keys (the
    (hi, lo) columns joined). targets: (Q,) uint32 global ranks. Returns s_mid (Q,)
    int32 = how many local elements rank below each boundary; the s_mid
    sum over shards equals each target exactly, so the received rank
    ranges tile the array.

    Instead of a bit-by-bit bisection (64 psum rounds for a 32-bit key
    plus its idx), selection takes:

    1. **Multi-probe key bisection** — ceil(key_bits/k) rounds, each
       counting 2^k equispaced probes per target in one `psum` (vectorized
       searchsorted locally). k=16 => TWO rounds (FOUR for u64) to pin the
       exact boundary key K_t (smallest v with global count_le(v) > t).
    2. **Closed-form tie distribution — ZERO extra selection rounds.**
       The stability tie-break idx is the contiguous global iota, sharded
       contiguously by shard_map: every idx on shard s precedes every idx
       on shard s+1, so among key==K_t ties, global idx order IS shard
       order. One tiny all_gather of each shard's (count key < K_t,
       count key == K_t) lets every shard compute its own prefix of the
       tie run in closed form: take_s = clip(t_ties - ties_before_s, 0, m_s).

    Collective rounds (32-bit): 2 psums + 1 all_gather (D <= 64; 4+1
    above) vs the old 64 psums + 1 gather; 64-bit keys pay 4+1 (8+1) —
    the same tie distribution applies unchanged because idx is still the
    contiguous iota.
    """
    q = targets.shape[0]
    key_bits = 64 if sk.dtype == jnp.uint64 else 32
    k = _probe_log2(n_dev)
    n_rounds = (key_bits + k - 1) // k
    j = jnp.arange(1 << k, dtype=sk.dtype)

    lo = jnp.zeros((q,), sk.dtype)
    for r in range(n_rounds):
        shift = key_bits - (r + 1) * k
        # probes = right edges of the 2^k sub-intervals of
        # [lo, lo + 2^(key_bits - r*k))
        probes = (
            lo[:, None] + (j[None, :] << shift)
            + jnp.asarray((1 << shift) - 1, sk.dtype)
        )
        c_local = jnp.searchsorted(
            sk, probes.reshape(-1), side="right"
        ).astype(jnp.uint32)
        c = jax.lax.psum(c_local, axis_name).reshape(q, 1 << k)
        # first sub-interval whose right-edge count exceeds the target
        # (counts are monotone in j, so "first True" == count of Falses)
        jstar = jnp.sum((c <= targets[:, None]).astype(jnp.uint32), axis=1)
        lo = lo + (jstar.astype(sk.dtype) << shift)
    K = lo  # exact boundary keys

    a = jnp.searchsorted(sk, K, side="left").astype(jnp.int32)   # key < K
    m = jnp.searchsorted(sk, K, side="right").astype(jnp.int32) - a  # == K
    am = jax.lax.all_gather(jnp.stack([a, m]), axis_name)  # (D, 2, Q)
    t_ties = targets.astype(jnp.int32) - jnp.sum(am[:, 0], axis=0)
    me = jax.lax.axis_index(axis_name)
    mine = (jnp.arange(n_dev, dtype=jnp.int32) < me)[:, None]
    ties_before = jnp.sum(am[:, 1] * mine, axis=0)
    take = jnp.clip(t_ties - ties_before, 0, m)
    return a + take


def ragged_all_to_all_emulated(
    a, out_buf, starts, sizes, out_offsets, *, axis_name, n_dev
):
    """Emulation of `jax.lax.ragged_all_to_all` for backends without the
    collective (XLA:CPU has no ragged-all-to-all thunk — verified on
    jax 0.9.0: `UNIMPLEMENTED ... ThunkEmitter`).

    Operational semantics pinned by `tests/test_radix_exchange.py::
    test_emulation_matches_ragged_all_to_all_semantics`: shard s sends
    `a[starts[s, d] : starts[s, d] + sizes[s, d]]` to shard d, where it
    lands at `out_offsets[s, d]` in d's copy of `out_buf` (positions not
    written by any chunk keep `out_buf`'s value, like the real collective's
    output operand); `starts` / `out_offsets` here are the ALL-GATHERED
    (D, D) matrices of every shard's per-destination metadata (the real
    collective takes each shard's own row and exchanges it implicitly).

    Mechanism: all_gather the data, then each shard assembles its received
    chunks with static-shape clipped-gather + masked select (no dynamic
    shapes under jit).
    """
    me = jax.lax.axis_index(axis_name)
    L = a.shape[0]
    pos = jnp.arange(out_buf.shape[0], dtype=jnp.int32)
    full = jax.lax.all_gather(a, axis_name)  # (D, L)
    buf = out_buf
    for s in range(n_dev):
        off = out_offsets[s, me]
        sz = sizes[s, me]
        src = jnp.take(
            full[s],
            jnp.clip(pos - off + starts[s, me], 0, L - 1),
        )
        buf = jnp.where((pos >= off) & (pos < off + sz), src, buf)
    return buf


def _shard_exchange_sort(arrs, *, axis_name, n_dev, use_ragged_a2a,
                         n_key_cols=1):
    """Per-shard body: local sort -> exact split -> ragged a2a -> re-sort.

    `n_key_cols`: leading key columns in `arrs` (1 for u32 keys, 2 for the
    wide (hi, lo) pair); the idx tie column follows them either way.
    """
    n_keys = n_key_cols + 1  # + idx tie column
    arrs = _local_sort(arrs, n_keys)
    if n_dev == 1:
        return arrs
    if n_key_cols == 2:
        # the splitter bisects the joined u64 domain (wide keys require
        # x64 mode upstream, so the join is representable)
        sk = common._join_u64(arrs[0], arrs[1])
    else:
        sk = arrs[0]
    L = sk.shape[0]
    me = jax.lax.axis_index(axis_name)

    targets = (jnp.arange(1, n_dev, dtype=jnp.uint32)) * jnp.uint32(L)
    s_mid = _select_splits(sk, targets, axis_name=axis_name, n_dev=n_dev)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), s_mid])
    ends = jnp.concatenate([s_mid, jnp.full((1,), L, jnp.int32)])
    send_sizes = ends - starts

    # size matrix: sizes[s, d] = what shard s sends to shard d
    sizes = jax.lax.all_gather(send_sizes, axis_name)  # (D, D)
    recv_sizes = sizes[:, me]

    # delivery layout: source s's chunk lands after the chunks of sources
    # < s, so every shard's L received elements fill its buffer exactly
    contig_before = jnp.cumsum(sizes, axis=0) - sizes  # exclusive over sources
    out_offsets = contig_before[me].astype(jnp.int32)

    out = []
    if not use_ragged_a2a:
        # backends without the collective (CPU test meshes): semantics-
        # pinned emulation, see ragged_all_to_all_emulated
        starts_g = jax.lax.all_gather(starts, axis_name)  # (D, D)
        offs_g = jax.lax.all_gather(out_offsets, axis_name)  # (D, D)
        for a in arrs:
            out.append(
                ragged_all_to_all_emulated(
                    a, jnp.zeros_like(a), starts_g, sizes, offs_g,
                    axis_name=axis_name, n_dev=n_dev,
                )
            )
    else:
        for a in arrs:
            out.append(
                jax.lax.ragged_all_to_all(
                    a,
                    jnp.zeros_like(a),
                    starts,
                    send_sizes,
                    out_offsets,
                    recv_sizes,
                    axis_name=axis_name,
                )
            )
    return _local_sort(out, n_keys)


def exchange_sort(
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
    use_ragged_a2a=None,
):
    """Distributed stable sort via exact-splitter radix exchange.

    Same semantics and signature as :func:`mesh_sort` (first `count` sorted,
    suffix untouched, low `bit_count` bits ordered, stable; `descending`
    via the flipped-masked-key trick like the single-chip path). One data
    exchange; exactly balanced under any key distribution.

    ``check_order=True``: distributed early-exit gate (psum of per-shard
    fast-gated checks + boundary-pair ppermute, `parallel/check.py`); a
    globally-sorted input skips the local sorts AND the exchange.

    64-bit key dtypes (uint64/int64/float64, under jax x64 mode) travel as
    (hi, lo) u32 columns like the single-chip path (`ops/sort64.py`); the
    splitter bisects the joined u64 probe domain (4 psum rounds at k=16
    instead of 2), the tie distribution is unchanged (idx is still the
    contiguous iota), and the exchange moves one extra column — so wide
    keys keep the one-data-crossing property (`bit_count` extends to
    4..64).

    `use_ragged_a2a` picks the exchange transport: True =
    `jax.lax.ragged_all_to_all` (GPU meshes), False = the semantics-pinned
    emulation (`ragged_all_to_all_emulated` — XLA:CPU has no
    ragged-all-to-all thunk), None = True exactly when no mesh device is a
    CPU.
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
    if use_ragged_a2a is None:
        # any CPU device => emulation: XLA:CPU cannot run the collective
        use_ragged_a2a = not any(
            d.platform == "cpu" for d in mesh.devices.flat
        )
    if count <= 1:
        return keys if values is None else (keys, values)
    return _exchange_sort_core(
        keys, values, mesh=mesh, axis_name=axis_name, count=count,
        bit_count=bit_count, check_order=check_order,
        total_order=total_order, descending=descending,
        use_ragged_a2a=use_ragged_a2a,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis_name", "count", "bit_count",
                     "check_order", "total_order", "descending",
                     "use_ragged_a2a"),
)
def _exchange_sort_core(keys, values, *, mesh, axis_name, count, bit_count,
                        check_order, total_order, descending,
                        use_ragged_a2a):
    """Jitted body of :func:`exchange_sort` (inputs already validated); one
    compiled program per static configuration."""
    wide = common.is_64bit_key_dtype(keys.dtype)
    n = keys.shape[0]
    n_dev = mesh.shape[axis_name]
    per = max(MIN_SHARD_LEN, common.next_pow2(common.cdiv(count, n_dev)))
    n_pad = per * n_dev

    if wide:
        if total_order:
            full_cols = common.to_total_order_u64_cols(keys[:count])
        else:
            full_cols = common.to_sortable_u64_cols(keys[:count])
        masks = common.bit_mask_cols(bit_count)
        masked = bit_count < 64
        mcols = tuple(c & m for c, m in zip(full_cols, masks))
        if descending:
            mcols = tuple(c ^ m for c, m in zip(mcols, masks))
        # bit_count <= 32: the masked hi column is all-zero — drop it (the
        # splitter then runs the plain u32 bisection; masked => carry_full)
        key_cols = (mcols[1],) if bit_count <= 32 else mcols
    else:
        if total_order:
            full_cols = (common.to_total_order_u32(keys[:count]),)
        else:
            full_cols = (common.to_sortable_u32(keys[:count]),)
        masks = (common.bit_mask(bit_count),)
        masked = bit_count < common.native_key_bits(keys.dtype)
        mk = full_cols[0] & masks[0]
        if descending:
            # stable descending == stable ascending on the flipped masked key
            mk = mk ^ masks[0]
        key_cols = (mk,)
    carry_full = masked or descending

    mk_cols = tuple(
        common.pad_to(c, n_pad, common.SENTINEL_U32) for c in key_cols
    )
    idx = jnp.arange(n_pad, dtype=jnp.uint32)
    arrs = [*mk_cols, idx]
    if carry_full:
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
            _shard_exchange_sort,
            axis_name=axis_name,
            n_dev=n_dev,
            use_ragged_a2a=use_ragged_a2a,
            n_key_cols=len(mk_cols),
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

    base = len(mk_cols) + 1  # key columns + idx tie column
    if carry_full:
        full_sorted = out[base: base + len(full_cols)]
    else:
        # unmasked ascending: the key columns ARE the full-key columns
        full_sorted = out[: len(full_cols)]
    if wide:
        s_hi, s_lo = (c[:count] for c in full_sorted)
        if total_order:
            out_keys = common.from_total_order_u64_cols(s_hi, s_lo, keys.dtype)
        else:
            out_keys = common.from_sortable_u64_cols(s_hi, s_lo, keys.dtype)
    else:
        u_sorted = full_sorted[0][:count]
        if total_order:
            out_keys = common.from_total_order_u32(u_sorted, keys.dtype)
        else:
            out_keys = common.from_sortable_u32(u_sorted, keys.dtype)
    if count < n:
        out_keys = jnp.concatenate([out_keys, keys[count:]])
    if values is None:
        return out_keys
    vbase = base + (len(full_cols) if carry_full else 0)
    v_sorted = tuple(c[:count] for c in out[vbase: vbase + len(vcols)])
    out_values = common.values_from_u32_cols(v_sorted, values.dtype)
    if count < n:
        out_values = jnp.concatenate([out_values, values[count:]])
    return out_keys, out_values
