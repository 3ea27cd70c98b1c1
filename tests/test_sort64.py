"""64-bit key sorts (uint64 / int64 / float64) vs the golden oracle.

Extension past the reference (32-bit-only buffers, `src/shaders/RadixSort.ts`):
`ops/sort64.py` runs 64-bit keys as (hi, lo) u32 columns sorted with
`lax.sort(num_keys=2)`. Requires jax x64 mode for the input dtype —
enabled module-scoped here, with cache clears so no 32-bit test's compiled
pipelines leak across the mode switch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_radix_sort as trs
from tpu_radix_sort.models.golden import golden_sort, golden_is_sorted


@pytest.fixture(autouse=True, scope="module")
def _x64_mode():
    jax.config.update("jax_enable_x64", True)
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_x64", False)
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(20260818)


def _u64_keys(rng, n, dup_hi=True):
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    if dup_hi:
        # duplicate hi words so the (hi, lo) lexicographic chain is decisive
        k[: n // 2] = (k[: n // 2] & np.uint64(0xFFFFFFFF)) | (
            np.uint64(0xABCD1234) << np.uint64(32)
        )
    return k


def test_u64_keys_only(rng):
    for n in (500, 3000):
        k = _u64_keys(rng, n)
        out = trs.sort(jnp.asarray(k))
        assert out.dtype == jnp.uint64
        np.testing.assert_array_equal(np.asarray(out), golden_sort(k))


def test_u64_key_value_generic_and_ranks(rng):
    n = 900
    k = _u64_keys(rng, n)
    # all-equal run: stability must come from the tie-break
    k[100:200] = k[100]
    v = np.arange(n, dtype=np.uint32)
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    rk, rv = golden_sort(k, v)
    ok, ov = trs.sort(kj, vj)
    np.testing.assert_array_equal(np.asarray(ok), rk)
    np.testing.assert_array_equal(np.asarray(ov), rv)
    # a generic (non-iota) payload co-moves the same way
    pay = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    okp, ovp = trs.sort(kj, jnp.asarray(pay))
    rkp, rvp = golden_sort(k, pay)
    np.testing.assert_array_equal(np.asarray(okp), rkp)
    np.testing.assert_array_equal(np.asarray(ovp), rvp)


def test_u64_bit_counts_descending_count(rng):
    n = 600
    k = _u64_keys(rng, n, dup_hi=False)
    v = np.arange(n, dtype=np.uint32)
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    for bc in (16, 32, 40, 60):  # lo-only and two-column masked views
        ok, ov = trs.sort(kj, vj, bit_count=bc)
        rk, rv = golden_sort(k, v, bit_count=bc)
        np.testing.assert_array_equal(np.asarray(ok), rk, err_msg=str(bc))
        np.testing.assert_array_equal(np.asarray(ov), rv, err_msg=str(bc))
    c = 2 * n // 3
    okd = trs.sort(kj, descending=True, count=c)
    np.testing.assert_array_equal(
        np.asarray(okd), golden_sort(k, descending=True, count=c))


def test_i64_f64_bit_pattern_and_total_order(rng):
    n = 500
    i = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    f = (rng.random(n) - 0.5) * 1e9
    for arr in (i, f):
        aj = jnp.asarray(arr)
        np.testing.assert_array_equal(
            np.asarray(trs.sort(aj)), golden_sort(arr))
        np.testing.assert_array_equal(
            np.asarray(trs.sort(aj, total_order=True)),
            np.sort(arr, kind="stable"))
        np.testing.assert_array_equal(
            np.asarray(trs.sort(aj, total_order=True, descending=True)),
            np.sort(arr, kind="stable")[::-1])


def test_u64_engines_agree(rng):
    n = 700
    k = _u64_keys(rng, n)
    v = np.arange(n, dtype=np.uint32)
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    rk, rv = golden_sort(k, v)
    for m in ("auto", "xla"):
        ok, ov = trs.sort(kj, vj, method=m)
        np.testing.assert_array_equal(np.asarray(ok), rk, err_msg=m)
        np.testing.assert_array_equal(np.asarray(ov), rv, err_msg=m)
        np.testing.assert_array_equal(
            np.asarray(trs.sort(kj, bit_count=40, method=m)),
            golden_sort(k, bit_count=40), err_msg=m)


def test_u64_check_order_gate_fires(rng, monkeypatch):
    """Sorted input must take the passthrough branch: poison the engine so
    only a fired gate can produce the right answer (the same poison pattern
    as the mesh gate tests)."""
    from tpu_radix_sort.ops import sort64

    n = 800
    k = _u64_keys(rng, n)
    ks = golden_sort(k)
    out = trs.sort(jnp.asarray(k), check_order=True)
    np.testing.assert_array_equal(np.asarray(out), ks)  # unsorted: sorts

    real = sort64.engine_sort

    def poisoned(key_cols, payloads, **kw):
        kc, ps = real(key_cols, payloads, **kw)
        return tuple(c ^ jnp.uint32(0xDEADBEEF) for c in kc), ps

    monkeypatch.setattr(sort64, "engine_sort", poisoned)
    # _sort_jit64 is jitted: drop the cached clean pipeline so the poisoned
    # engine actually enters the new trace (and clear again afterwards so
    # no poisoned executable leaks into later tests)
    jax.clear_caches()
    try:
        out_s = trs.sort(jnp.asarray(ks), check_order=True)
        np.testing.assert_array_equal(np.asarray(out_s), ks)  # gate fired
        out_u = trs.sort(jnp.asarray(k), check_order=True)
        assert not np.array_equal(np.asarray(out_u), ks)  # poison visible
    finally:
        jax.clear_caches()


def test_u64_order_checks(rng):
    n = 600
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    ks = golden_sort(k)
    assert bool(trs.is_sorted(jnp.asarray(ks)))
    assert not bool(trs.is_sorted(jnp.asarray(k)))
    assert int(trs.disorder_count(jnp.asarray(ks))) == 0
    assert int(trs.disorder_count(jnp.asarray(k))) == int(
        np.sum(k[:-1] > k[1:]))
    c = n // 2
    assert int(trs.disorder_count(jnp.asarray(k), count=c)) == int(
        np.sum(k[: c - 1] > k[1:c]))
    assert bool(trs.is_sorted(jnp.asarray(k), bit_count=4)) == golden_is_sorted(
        k, bit_count=4)


def test_u64_order_check_large(rng):
    # a large, non-power-of-two two-column check, incl. an inversion past
    # the fast window
    m = 300_000
    big = np.sort(rng.integers(0, 2**64, m, dtype=np.uint64))
    assert bool(trs.is_sorted(jnp.asarray(big)))
    big[m // 2] = 0
    assert int(trs.disorder_count(jnp.asarray(big))) == int(
        np.sum(big[:-1] > big[1:]))


def test_u64_keys_only_both_directions(rng):
    """u64 keys-only is a 2-column (hi, lo) sort with no payload."""
    n = 900
    k = _u64_keys(rng, n)
    np.testing.assert_array_equal(
        np.asarray(trs.sort(jnp.asarray(k))), golden_sort(k))
    np.testing.assert_array_equal(
        np.asarray(trs.sort(jnp.asarray(k), descending=True)),
        golden_sort(k, descending=True))


def _mesh8():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:8]), ("x",))


def test_u64_mesh_sort(rng):
    """Distributed 64-bit sort: compare-split network over (hi, lo, idx)
    column tuples (parallel/mesh_sort.py nk=3). Routed via the public
    sort(mesh=) entrypoint (auto picks compare-split for wide keys)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = _mesh8()
    sh = NamedSharding(mesh, P("x"))
    n = 4096
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    k[: n // 2] = (k[: n // 2] & np.uint64(0xFFFF)) | (
        np.uint64(7) << np.uint64(32))  # duplicate-heavy: tie-break load
    v = np.arange(n, dtype=np.uint32)
    kj = jax.device_put(jnp.asarray(k), sh)
    vj = jax.device_put(jnp.asarray(v), sh)

    np.testing.assert_array_equal(
        np.asarray(trs.sort(kj, mesh=mesh)), golden_sort(k))
    ok, ov = trs.sort(kj, vj, mesh=mesh)
    rk, rv = golden_sort(k, v)
    np.testing.assert_array_equal(np.asarray(ok), rk)
    np.testing.assert_array_equal(np.asarray(ov), rv)
    ok40, ov40 = trs.sort(kj, vj, mesh=mesh, bit_count=40, descending=True)
    rk40, rv40 = golden_sort(k, v, bit_count=40, descending=True)
    np.testing.assert_array_equal(np.asarray(ok40), rk40)
    np.testing.assert_array_equal(np.asarray(ov40), rv40)
    c = 3000
    np.testing.assert_array_equal(
        np.asarray(trs.sort(kj, mesh=mesh, count=c)), golden_sort(k, count=c))
    # the exchange splitter bisects the joined u64 domain: wide keys ride
    # the one-crossing strategy too
    ok_x, ov_x = trs.sort(kj, vj, mesh=mesh, method="exchange")
    np.testing.assert_array_equal(np.asarray(ok_x), rk)
    np.testing.assert_array_equal(np.asarray(ov_x), rv)


def test_u64_mesh_checks_and_gate(rng):
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = _mesh8()
    sh = NamedSharding(mesh, P("x"))
    n = 4096
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    ks = golden_sort(k)
    kj = jax.device_put(jnp.asarray(k), sh)
    ksj = jax.device_put(jnp.asarray(ks), sh)
    np.testing.assert_array_equal(
        np.asarray(trs.sort(ksj, mesh=mesh, check_order=True)), ks)
    assert bool(trs.is_sorted(ksj, mesh=mesh))
    assert not bool(trs.is_sorted(kj, mesh=mesh))
    assert int(trs.disorder_count(kj, mesh=mesh)) == int(
        np.sum(k[:-1] > k[1:]))
    c = n // 3
    assert int(trs.disorder_count(kj, mesh=mesh, count=c)) == int(
        np.sum(k[: c - 1] > k[1:c]))


@pytest.mark.slow
def test_u64_breadth_sweep(rng):
    """Randomized configuration matrix for 64-bit keys (the reference's
    `example/tests.ts:19-42` sweep shape applied to the extension): drawn
    n, sub-counts, bit_counts 4..64, dtypes, flags, tile shapes — each
    byte-exact vs the golden oracle."""
    for i in range(36):
        if i % 9 == 0:
            jax.clear_caches()
        n = int(rng.integers(150, 2500))
        count = n if rng.random() < 0.5 else int(rng.integers(0, n + 1))
        bit_count = int(rng.choice([4, 16, 32, 36, 48, 64, 64]))
        dtype = str(rng.choice(["uint64", "uint64", "int64", "float64"]))
        descending = rng.random() < 0.2
        check_order = rng.random() < 0.2
        with_values = rng.random() < 0.5
        total_order = bit_count == 64 and rng.random() < 0.2

        if dtype == "uint64":
            k = rng.integers(0, 2**64, n, dtype=np.uint64)
            if rng.random() < 0.3:  # hi-word duplicates: column-chain edge
                k = (k & np.uint64(0xFFFF)) | (np.uint64(3) << np.uint64(32))
        elif dtype == "int64":
            k = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
        else:
            k = ((rng.random(n) - 0.5) * 1e12)

        cfg = (i, n, count, bit_count, dtype, descending, check_order,
               with_values, total_order)
        kj = jnp.asarray(k)
        kwargs = dict(count=count, bit_count=bit_count, descending=descending,
                      check_order=check_order, total_order=total_order)

        if total_order:
            # exact numeric-order oracle: monotone map to u64, complement
            # for descending (exact reversal — no unsigned-negate wrap or
            # INT64_MIN edge)
            seg = k[:count]
            if dtype == "uint64":
                u = seg.copy()
            elif dtype == "int64":
                u = seg.view(np.uint64) ^ np.uint64(1 << 63)
            else:
                b = seg.view(np.uint64)
                flip = np.where(b >> np.uint64(63) == 1,
                                np.uint64(0xFFFFFFFFFFFFFFFF),
                                np.uint64(1 << 63))
                u = b ^ flip
            order = np.argsort(~u if descending else u, kind="stable")
            rk = k.copy()
            rk[:count] = seg[order]
        else:
            order = None

        if with_values:
            v = np.arange(n, dtype=np.uint32)
            ok, ov = trs.sort(kj, jnp.asarray(v), **kwargs)
            if total_order:
                rv = v.copy()
                rv[:count] = v[:count][order]
            else:
                rk, rv = golden_sort(k, v, count=count, bit_count=bit_count,
                                     descending=descending)
            np.testing.assert_array_equal(np.asarray(ok), rk, err_msg=str(cfg))
            np.testing.assert_array_equal(np.asarray(ov), rv, err_msg=str(cfg))
        else:
            out = trs.sort(kj, **kwargs)
            if not total_order:
                rk = golden_sort(k, count=count, bit_count=bit_count,
                                 descending=descending)
            np.testing.assert_array_equal(np.asarray(out), rk, err_msg=str(cfg))
    jax.clear_caches()


def test_u64_nonpow2_matches_golden(rng):
    """Non-power-of-two lengths of 64-bit keys, with and without payloads,
    masked and sub-counted."""
    for n in (300, 1040, 1324):
        k = rng.integers(0, 2**64, n, dtype=np.uint64)
        k[: n // 3] = (k[: n // 3] & np.uint64(0xFF)) | (
            np.uint64(5) << np.uint64(32))  # duplicates: stability load
        v = np.arange(n, dtype=np.uint32)
        kj, vj = jnp.asarray(k), jnp.asarray(v)
        rk, rv = golden_sort(k, v)
        np.testing.assert_array_equal(np.asarray(trs.sort(kj)), rk)
        ok, ov = trs.sort(kj, vj)
        np.testing.assert_array_equal(np.asarray(ok), rk, err_msg=str(n))
        np.testing.assert_array_equal(np.asarray(ov), rv, err_msg=str(n))
        c = (2 * n) // 3
        np.testing.assert_array_equal(
            np.asarray(trs.sort(kj, count=c, bit_count=40)),
            golden_sort(k, count=c, bit_count=40))
    # real all-ones u64 keys keep their stable order
    n = 1040
    k = np.full(n, 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)
    k[rng.integers(0, n, 200)] = rng.integers(0, 2**64, 200, dtype=np.uint64)
    v = np.arange(n, dtype=np.uint32)
    rk, rv = golden_sort(k, v)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(np.asarray(ok), rk)
    np.testing.assert_array_equal(np.asarray(ov), rv)


def test_u64_batched(rng):
    """Per-row 64-bit sorts: the (row, hi, lo) 3-column lexicographic
    tuple through `sort_batched` (ops/batched.py)."""
    B, n = 5, 256
    k = rng.integers(0, 2**64, (B, n), dtype=np.uint64)
    k[1] = (k[1] & np.uint64(0xFF)) | (np.uint64(9) << np.uint64(32))
    v = np.tile(np.arange(n, dtype=np.uint32), (B, 1))
    ref_k = np.sort(k, axis=1, kind="stable")
    ref_o = np.argsort(k, axis=1, kind="stable").astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(trs.sort_batched(jnp.asarray(k))), ref_k)
    ok, ov = trs.sort_batched(jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(np.asarray(ok), ref_k)
    np.testing.assert_array_equal(np.asarray(ov), ref_o)
    mk = k & np.uint64((1 << 40) - 1)
    o40 = np.argsort(mk, axis=1, kind="stable")
    np.testing.assert_array_equal(
        np.asarray(trs.sort_batched(jnp.asarray(k), bit_count=40)),
        np.take_along_axis(k, o40, axis=1))


def test_u64_segments(rng):
    """Ragged 64-bit segments: (seg, hi, lo) lexicographic columns."""
    n = 1200
    cuts = np.sort(rng.choice(np.arange(1, n), size=6, replace=False))
    offs = np.concatenate([[0], cuts, [n]]).astype(np.int32)
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    v = np.arange(n, dtype=np.uint32)
    rk, rv = k.copy(), v.copy()
    for a, b in zip(offs[:-1], offs[1:]):
        o = np.argsort(rk[a:b], kind="stable")
        rk[a:b] = rk[a:b][o]
        rv[a:b] = v[a:b][o]
    ok, ov = trs.sort_segments(jnp.asarray(k), jnp.asarray(offs),
                               jnp.asarray(v))
    np.testing.assert_array_equal(np.asarray(ok), rk)
    np.testing.assert_array_equal(np.asarray(ov), rv)


def test_u64_kernel_class(rng):
    """Construct-once/dispatch-many surface with 64-bit keys (key_dtype
    option; bit_count defaults to the key width) incl. the AOT compile."""
    n = 800
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    v = np.arange(n, dtype=np.uint32)
    kern = trs.RadixSortKernel(count=n, has_values=True,
                               key_dtype=jnp.uint64)
    ok, ov = kern.dispatch(jnp.asarray(k), jnp.asarray(v))
    rk, rv = golden_sort(k, v)
    np.testing.assert_array_equal(np.asarray(ok), rk)
    np.testing.assert_array_equal(np.asarray(ov), rv)
    kern.compile()  # AOT path with u64 avals
    k16 = trs.RadixSortKernel(count=n, key_dtype=jnp.uint64, bit_count=16)
    np.testing.assert_array_equal(
        np.asarray(k16.dispatch(jnp.asarray(k))), golden_sort(k, bit_count=16))
    with pytest.raises(ValueError):
        trs.RadixSortKernel(count=n, key_dtype=jnp.uint64, bit_count=65)
    with pytest.raises(ValueError):
        trs.RadixSortKernel(count=n, key_dtype=jnp.uint32, bit_count=64)


def test_u64_validation():
    k = jnp.zeros(8, jnp.uint64)
    with pytest.raises(ValueError):
        trs.sort(k, bit_count=65)
    with pytest.raises(ValueError):
        trs.sort(k, bit_count=6)
    # 64-bit values are supported (test_values64);
    # sub-4-byte payloads are not a payload width
    with pytest.raises(TypeError):
        trs.sort(k, jnp.zeros(8, jnp.float16))
    with pytest.raises(ValueError):
        trs.sort(k, count=9)


def test_u64_check_flags(rng):
    """total_order / descending on the 64-bit check view: negative float64 / int64 and descending output verify under
    the same flags the sort ran with."""
    n = 3000
    f = rng.standard_normal(n).astype(np.float64)
    s_to = trs.sort(jnp.asarray(f), total_order=True)
    assert bool(trs.is_sorted(s_to, total_order=True))
    assert int(trs.disorder_count(s_to, total_order=True)) == 0
    # raw u64 bit-pattern view of totally-ordered negatives is unsorted
    assert not bool(trs.is_sorted(s_to))
    assert golden_is_sorted(np.asarray(s_to), total_order=True)

    k = _u64_keys(rng, n)
    s_d = trs.sort(jnp.asarray(k), descending=True)
    assert bool(trs.is_sorted(s_d, descending=True))
    assert not bool(trs.is_sorted(s_d))
    assert golden_is_sorted(np.asarray(s_d), descending=True)

    i = rng.integers(-(2**62), 2**62, n).astype(np.int64)
    s_td = trs.sort(jnp.asarray(i), total_order=True, descending=True,
                    bit_count=40)
    assert bool(trs.is_sorted(s_td, total_order=True, descending=True,
                              bit_count=40))
    assert golden_is_sorted(np.asarray(s_td), total_order=True,
                            descending=True, bit_count=40)
    # bit_count <= 32 drops to the single-column path; flags still apply
    s_lo = trs.sort(jnp.asarray(k), descending=True, bit_count=16)
    assert bool(trs.is_sorted(s_lo, descending=True, bit_count=16))
