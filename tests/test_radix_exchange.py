"""Exact-splitter radix-exchange distributed sort (single all-to-all).

Covers the skew cases the compare-split network is immune to by
construction: Zipf-hot buckets and all-equal keys, where value-based
partitioning would collapse — rank-based splitting must stay exactly
balanced and correct.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_radix_sort.models.golden import golden_sort
from tpu_radix_sort.parallel import sharded
from tpu_radix_sort.parallel.radix_exchange import (
    exchange_sort,
    ragged_all_to_all_emulated,
)
from jax.sharding import Mesh, PartitionSpec as P


def make_mesh(n):
    devs = jax.devices("cpu")[:n]
    return Mesh(np.array(devs), ("x",))


@pytest.mark.parametrize("n_dev,n", [(2, 512), (8, 20000)])
def test_exchange_sort_keys(rng, n_dev, n):
    mesh = make_mesh(n_dev)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    got = exchange_sort(sharded(mesh, "x", jnp.asarray(keys)), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), golden_sort(keys))


def test_exchange_sort_kv_stability(rng):
    mesh = make_mesh(8)
    n = 10000
    keys = rng.integers(0, 2**6, size=n, dtype=np.uint32)  # heavy duplicates
    values = np.arange(n, dtype=np.uint32)
    gk, gv = exchange_sort(
        sharded(mesh, "x", jnp.asarray(keys)),
        sharded(mesh, "x", jnp.asarray(values)),
        mesh=mesh,
    )
    rk, rv = golden_sort(keys, values)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)


def test_exchange_sort_skew(rng):
    """Zipf-hot and all-equal keys: rank splitting must stay balanced."""
    mesh = make_mesh(8)
    n = 8192
    z = rng.zipf(1.2, size=n).astype(np.uint32)
    got = exchange_sort(sharded(mesh, "x", jnp.asarray(z)), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), golden_sort(z))

    eq = np.full(n, 7, dtype=np.uint32)  # same shapes: reuses compilation
    v = np.arange(n, dtype=np.uint32)
    gk, gv = exchange_sort(
        sharded(mesh, "x", jnp.asarray(eq)),
        sharded(mesh, "x", jnp.asarray(v)),
        mesh=mesh,
    )
    np.testing.assert_array_equal(np.asarray(gk), eq)
    np.testing.assert_array_equal(np.asarray(gv), v)


def test_emulation_matches_ragged_all_to_all_semantics(rng):
    """Pin the CPU emulation to `jax.lax.ragged_all_to_all`'s documented
    operational semantics (XLA:CPU cannot run the real collective —
    `UNIMPLEMENTED: HLO opcode ragged-all-to-all ... ThunkEmitter` on
    jax 0.9.0 — so the equivalence oracle is an independent NumPy model):
    shard s's slice [starts[s,d], starts[s,d]+sizes[s,d]) lands in shard
    d's output at offset out_offsets[s,d]; untouched output positions keep
    the destination buffer's initial value (zeros here)."""
    D, L = 8, 64
    mesh = make_mesh(D)
    data = rng.integers(0, 2**32, size=(D, L), dtype=np.uint32)

    for trial in range(3):
        # random ragged metadata: per-source contiguous send layout, and
        # per-destination column sums <= L so every chunk fits
        sizes = rng.integers(0, L // D + 1, size=(D, D)).astype(np.int32)
        starts = np.zeros((D, D), np.int32)
        starts[:, 1:] = np.cumsum(sizes, axis=1)[:, :-1]
        out_offsets = np.zeros((D, D), np.int32)
        out_offsets[1:, :] = np.cumsum(sizes, axis=0)[:-1, :]

        # independent NumPy model of the documented semantics
        expect = np.zeros((D, L), np.uint32)
        for s in range(D):
            for d in range(D):
                sz = sizes[s, d]
                expect[d, out_offsets[s, d]:out_offsets[s, d] + sz] = \
                    data[s, starts[s, d]:starts[s, d] + sz]

        fn = jax.jit(
            jax.shard_map(
                lambda a: ragged_all_to_all_emulated(
                    a,
                    jnp.zeros((L,), jnp.uint32),
                    jnp.asarray(starts),
                    jnp.asarray(sizes),
                    jnp.asarray(out_offsets),
                    axis_name="x",
                    n_dev=D,
                ),
                mesh=mesh,
                in_specs=P("x"),
                out_specs=P("x"),
                check_vma=False,
            )
        )
        got = np.asarray(fn(jnp.asarray(data.reshape(-1)))).reshape(D, L)
        np.testing.assert_array_equal(got, expect, err_msg=f"trial {trial}")


def test_exchange_sort_flags(rng):
    mesh = make_mesh(4)
    n = 5000
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    got = exchange_sort(
        sharded(mesh, "x", jnp.asarray(keys)), mesh=mesh, bit_count=8,
        count=3333,
    )
    np.testing.assert_array_equal(
        np.asarray(got), golden_sort(keys, bit_count=8, count=3333)
    )


def test_exchange_sort_descending(rng):
    mesh = make_mesh(4)
    n = 1000
    keys = rng.integers(0, 2**8, size=n, dtype=np.uint32)  # dupes: stability
    values = np.arange(n, dtype=np.uint32)
    gk, gv = exchange_sort(
        sharded(mesh, "x", jnp.asarray(keys)),
        sharded(mesh, "x", jnp.asarray(values)),
        mesh=mesh,
        descending=True,
    )
    rk, rv = golden_sort(keys, values, descending=True)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)


def test_exchange_sort_check_order(rng):
    """Distributed early-exit gate on the exchange strategy: sorted passthrough is byte-exact; boundary-only disorder and
    random input still reach golden."""
    mesh = make_mesh(8)
    n = 4096
    values = np.arange(n, dtype=np.uint32)
    srt = np.sort(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    gk, gv = exchange_sort(
        sharded(mesh, "x", jnp.asarray(srt)),
        sharded(mesh, "x", jnp.asarray(values)),
        mesh=mesh, check_order=True,
    )
    np.testing.assert_array_equal(np.asarray(gk), srt)
    np.testing.assert_array_equal(np.asarray(gv), values)

    bad = srt.copy()
    half = n // 2  # a shard boundary on the 8-device mesh
    bad[half - 1], bad[half] = bad[half], bad[half - 1]
    if bad[half - 1] == bad[half]:
        bad[half - 1] += 1
    gk = exchange_sort(sharded(mesh, "x", jnp.asarray(bad)), mesh=mesh,
                       check_order=True)
    np.testing.assert_array_equal(np.asarray(gk), golden_sort(bad))


def test_exchange_sort_podscale_probe_path(rng, monkeypatch):
    """The k=8 multi-probe bisection path (4 rounds of 256 probes) only
    engages at D > 65 devices (`_probe_log2`), which no CPU mesh reaches —
    force it on the 8-device mesh so both probe geometries are exercised
    end-to-end, including tie distribution under heavy duplicates."""
    from tpu_radix_sort.parallel import radix_exchange as rx_mod

    assert rx_mod._probe_log2(8) == 16
    assert rx_mod._probe_log2(256) == 8
    monkeypatch.setattr(rx_mod, "_probe_log2", lambda n_dev: 8)
    mesh = make_mesh(8)
    n = 6000
    keys = rng.integers(0, 2**6, size=n, dtype=np.uint32)  # heavy duplicates
    values = np.arange(n, dtype=np.uint32)
    gk, gv = exchange_sort(
        sharded(mesh, "x", jnp.asarray(keys)),
        sharded(mesh, "x", jnp.asarray(values)),
        mesh=mesh,
    )
    rk, rv = golden_sort(keys, values)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)


def test_exchange_check_order_gate_actually_fires(rng, monkeypatch):
    """Round-3 advisor: equality on sorted input also passes if the gate
    silently re-sorts. Poison the sort branch: the passthrough must keep
    the output clean at runtime (`lax.cond` executes one branch)."""
    from tpu_radix_sort.parallel import radix_exchange as rx_mod

    mesh = make_mesh(4)
    n = 2048
    real = rx_mod._shard_exchange_sort

    def poisoned(arrs, **kw):
        return tuple(a ^ jnp.uint32(0xDEAD) for a in real(arrs, **kw))

    monkeypatch.setattr(rx_mod, "_shard_exchange_sort", poisoned)
    jax.clear_caches()  # the core is jitted: trace the poisoned body
    try:
        srt = np.sort(rng.integers(0, 2**32, size=n, dtype=np.uint32))
        got = exchange_sort(sharded(mesh, "x", jnp.asarray(srt)), mesh=mesh,
                            check_order=True)
        np.testing.assert_array_equal(np.asarray(got), srt)  # gate fired
        rnd = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        got = exchange_sort(sharded(mesh, "x", jnp.asarray(rnd)), mesh=mesh,
                            check_order=True)
        assert not np.array_equal(np.asarray(got), golden_sort(rnd))
    finally:
        jax.clear_caches()


def test_exchange_sort_merge_and_fallback_branches(rng):
    """Received chunks of balanced sizes (uniform data) and of maximally
    skewed sizes (already-sorted input sends one full-L chunk per shard)
    must both re-sort to golden byte-exactly; stability pinned with heavy
    duplicates."""
    mesh = make_mesh(8)
    n = 8192
    values = np.arange(n, dtype=np.uint32)

    # uniform random keys -> every chunk ~L/D
    keys = rng.integers(0, 2**16, size=n, dtype=np.uint32)  # dupes
    gk, gv = exchange_sort(
        sharded(mesh, "x", jnp.asarray(keys)),
        sharded(mesh, "x", jnp.asarray(values)),
        mesh=mesh,
    )
    rk, rv = golden_sort(keys, values)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)

    # sorted keys -> shard d sends its whole block to d
    srt = np.sort(keys)
    gk, gv = exchange_sort(
        sharded(mesh, "x", jnp.asarray(srt)),
        sharded(mesh, "x", jnp.asarray(values)),
        mesh=mesh,
    )
    rk, rv = golden_sort(srt, values)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)


def test_exchange_sort_nonpow2_devices(rng):
    """Non-pow2 D: D-1 = 5 simultaneous splitter boundaries; output must
    still be golden."""
    mesh = make_mesh(6)
    n = 6000
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    got = exchange_sort(sharded(mesh, "x", jnp.asarray(keys)), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), golden_sort(keys))


def test_real_ragged_all_to_all_probe(rng):
    """Probe for the REAL `jax.lax.ragged_all_to_all` on the CPU test mesh.
    As of jax 0.9.0 XLA:CPU raises UNIMPLEMENTED (`ragged-all-to-all is not
    supported by XLA:CPU ThunkEmitter`). The test SKIPS on that error so
    the day the thunk lands, the golden checks below run automatically and
    the emulation note can retire. GPU meshes run the real collective
    (`chip_smoke.py --mesh4`)."""
    mesh = make_mesh(8)
    n = 4096
    keys = rng.integers(0, 2**16, size=n, dtype=np.uint32)
    values = np.arange(n, dtype=np.uint32)
    try:
        gk, gv = exchange_sort(
            sharded(mesh, "x", jnp.asarray(keys)),
            sharded(mesh, "x", jnp.asarray(values)),
            mesh=mesh, use_ragged_a2a=True,
        )
        np.asarray(gk)
    except Exception as e:
        if "ragged-all-to-all" in str(e) or "UNIMPLEMENTED" in str(e):
            pytest.skip(f"real ragged_all_to_all unavailable on XLA:CPU: "
                        f"{type(e).__name__}")
        raise
    rk, rv = golden_sort(keys, values)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)
    # skewed (sorted) input drives the contiguous-fallback offsets through
    # the real collective too
    srt = np.sort(keys)
    gk = exchange_sort(sharded(mesh, "x", jnp.asarray(srt)), mesh=mesh,
                       use_ragged_a2a=True)
    np.testing.assert_array_equal(np.asarray(gk), golden_sort(srt))


@pytest.fixture
def _x64():
    jax.config.update("jax_enable_x64", True)
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_x64", False)
    jax.clear_caches()


def _u64_with_hi_dups(rng, n):
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    # duplicated hi words load the lexicographic chain AND create cross-
    # shard key ties, exercising the closed-form tie distribution at the
    # joined-u64 boundary keys
    k[: n // 3] = (k[: n // 3] & np.uint64(0xFFFF)) | (
        np.uint64(7) << np.uint64(32))
    return k


def test_exchange_sort_u64_matrix(rng, _x64):
    """64-bit keys through the exact-splitter exchange: the splitter bisects the joined u64 probe domain (4 psum
    rounds at k=16); ties distribute closed-form exactly as for u32."""
    mesh = make_mesh(8)
    n = 4096
    k = _u64_with_hi_dups(rng, n)
    v = np.arange(n, dtype=np.uint32)
    kj, vj = sharded(mesh, "x", jnp.asarray(k)), sharded(mesh, "x", jnp.asarray(v))
    rk, rv = golden_sort(k, v)
    gk, gv = exchange_sort(kj, vj, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)
    # keys-only + sub-count suffix preservation
    c = 3000
    np.testing.assert_array_equal(
        np.asarray(exchange_sort(kj, mesh=mesh, count=c)),
        golden_sort(k, count=c))
    # masked + descending (carry-full path; hi column still in the tuple)
    np.testing.assert_array_equal(
        np.asarray(exchange_sort(kj, mesh=mesh, bit_count=40,
                                 descending=True)),
        golden_sort(k, bit_count=40, descending=True))
    # bit_count <= 32 drops the hi key column (lo_only): splitter runs the
    # plain u32 bisection while the (hi, lo) full pair rides as payload
    np.testing.assert_array_equal(
        np.asarray(exchange_sort(kj, mesh=mesh, bit_count=16)),
        golden_sort(k, bit_count=16))


def test_exchange_sort_u64_skew_and_all_equal(rng, _x64):
    mesh = make_mesh(8)
    n = 4096
    v = np.arange(n, dtype=np.uint32)
    # Zipf-in-lo under one hot hi word: heavy key ties across shards
    kz = (np.uint64(3) << np.uint64(32)) | rng.zipf(1.3, n).astype(np.uint64)
    rk, rv = golden_sort(kz, v)
    gk, gv = exchange_sort(sharded(mesh, "x", jnp.asarray(kz)),
                           sharded(mesh, "x", jnp.asarray(v)), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)
    # all-equal keys: every boundary is one giant tie run; stability must
    # come purely from the contiguous-iota distribution
    ke = np.full(n, 0x9E3779B97F4A7C15, dtype=np.uint64)
    gk, gv = exchange_sort(sharded(mesh, "x", jnp.asarray(ke)),
                           sharded(mesh, "x", jnp.asarray(v)), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(gk), ke)
    np.testing.assert_array_equal(np.asarray(gv), v)


def test_exchange_sort_u64_nonpow2_devices(rng, _x64):
    mesh = make_mesh(6)
    n = 6 * 512
    k = _u64_with_hi_dups(rng, n)
    v = np.arange(n, dtype=np.uint32)
    rk, rv = golden_sort(k, v)
    gk, gv = exchange_sort(sharded(mesh, "x", jnp.asarray(k)),
                           sharded(mesh, "x", jnp.asarray(v)), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)


def test_exchange_sort_u64_check_order(rng, _x64):
    mesh = make_mesh(8)
    n = 4096
    k = _u64_with_hi_dups(rng, n)
    srt = golden_sort(k)
    kj = sharded(mesh, "x", jnp.asarray(k))
    sj = sharded(mesh, "x", jnp.asarray(srt))
    # sorted input passes through byte-exact; unsorted still reaches golden
    np.testing.assert_array_equal(
        np.asarray(exchange_sort(sj, mesh=mesh, check_order=True)), srt)
    np.testing.assert_array_equal(
        np.asarray(exchange_sort(kj, mesh=mesh, check_order=True)), srt)


def test_exchange_sort_f64_i64_total_order(rng, _x64):
    mesh = make_mesh(8)
    n = 2048
    f = rng.standard_normal(n).astype(np.float64)  # negatives included
    got = exchange_sort(sharded(mesh, "x", jnp.asarray(f)), mesh=mesh,
                        total_order=True)
    np.testing.assert_array_equal(np.asarray(got), np.sort(f))
    i = rng.integers(-(2**62), 2**62, n).astype(np.int64)
    got = exchange_sort(sharded(mesh, "x", jnp.asarray(i)), mesh=mesh,
                        total_order=True)
    np.testing.assert_array_equal(np.asarray(got), np.sort(i))
