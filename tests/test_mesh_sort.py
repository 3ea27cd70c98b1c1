"""Multi-device mesh sort vs the golden model, on a virtual 8-device CPU mesh.

The reference has nothing multi-device to mirror (SURVEY.md §2.4); the test
matrix shape still follows its randomized-sweep style (`example/tests.ts`):
random counts, sub-counts, keys-only and key+value, masked bit_count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_radix_sort.models.golden import golden_sort
from tpu_radix_sort.parallel import mesh_sort, sharded
from jax.sharding import Mesh


def make_mesh(n):
    devs = jax.devices("cpu")[:n]
    return Mesh(np.array(devs), ("x",))


@pytest.mark.parametrize("n_dev,n", [(1, 256), (2, 1000), (8, 4096), (8, 20000)])
def test_mesh_sort_keys(rng, n_dev, n):
    mesh = make_mesh(n_dev)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    got = mesh_sort(sharded(mesh, "x", jnp.asarray(keys)), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), golden_sort(keys))


@pytest.mark.slow
@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("n", [256, 1000, 4096, 20000])
def test_mesh_sort_keys_full_matrix(rng, n_dev, n):
    mesh = make_mesh(n_dev)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    got = mesh_sort(sharded(mesh, "x", jnp.asarray(keys)), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), golden_sort(keys))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_mesh_sort_kv_and_subcount(rng, n_dev):
    mesh = make_mesh(n_dev)
    n = 5000
    count = 3777
    keys = rng.integers(0, 2**10, size=n, dtype=np.uint32)  # many duplicates
    values = np.arange(n, dtype=np.uint32)
    gk, gv = mesh_sort(
        sharded(mesh, "x", jnp.asarray(keys)),
        sharded(mesh, "x", jnp.asarray(values)),
        mesh=mesh,
        count=count,
    )
    rk, rv = golden_sort(keys, values, count=count)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)  # stability check


def test_mesh_sort_bit_count_and_float(rng):
    mesh = make_mesh(4)
    n = 3000
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    values = np.arange(n, dtype=np.uint32)
    gk, gv = mesh_sort(
        sharded(mesh, "x", jnp.asarray(keys)),
        sharded(mesh, "x", jnp.asarray(values)),
        mesh=mesh,
        bit_count=8,
    )
    rk, rv = golden_sort(keys, values, bit_count=8)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)

    f = rng.random(size=2048, dtype=np.float32) * 100.0
    got = mesh_sort(sharded(mesh, "x", jnp.asarray(f)), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), golden_sort(f))


@pytest.mark.parametrize("overlap_chunks", [2, 4])
def test_mesh_sort_overlapped_exchange(rng, overlap_chunks):
    """The chunked double-buffered exchange (comm/compute overlap
    groundwork, SURVEY.md §7) must be byte-identical to the plain path
    and to golden — key+value, duplicates, sub-count."""
    mesh = make_mesh(8)
    n = 6000
    count = 5000
    keys = rng.integers(0, 2**8, size=n, dtype=np.uint32)  # heavy dupes
    values = np.arange(n, dtype=np.uint32)
    kj, vj = jnp.asarray(keys), jnp.asarray(values)
    gk, gv = mesh_sort(
        sharded(mesh, "x", kj), sharded(mesh, "x", vj),
        mesh=mesh, count=count, overlap_chunks=overlap_chunks,
    )
    pk, pv = mesh_sort(
        sharded(mesh, "x", kj), sharded(mesh, "x", vj),
        mesh=mesh, count=count,
    )
    rk, rv = golden_sort(keys, values, count=count)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)
    np.testing.assert_array_equal(np.asarray(gk), np.asarray(pk))
    np.testing.assert_array_equal(np.asarray(gv), np.asarray(pv))


def test_mesh_sort_overlap_validation(rng):
    mesh = make_mesh(8)
    keys = jnp.asarray(rng.integers(0, 2**32, size=4096, dtype=np.uint32))
    with pytest.raises(ValueError):
        # per-shard padded length is 512 here; 7 does not divide it
        mesh_sort(sharded(mesh, "x", keys), mesh=mesh, overlap_chunks=7)


def test_mesh_sort_descending(rng):
    mesh = make_mesh(4)
    n = 1000
    keys = rng.integers(0, 2**8, size=n, dtype=np.uint32)  # dupes: stability
    values = np.arange(n, dtype=np.uint32)
    gk, gv = mesh_sort(
        sharded(mesh, "x", jnp.asarray(keys)),
        sharded(mesh, "x", jnp.asarray(values)),
        mesh=mesh,
        descending=True,
    )
    rk, rv = golden_sort(keys, values, descending=True)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)


def test_mesh_sort_total_order_negative_floats(rng):
    # the beyond-reference total order must hold across shards too
    mesh = make_mesh(4)
    f = (rng.random(1024) * 100 - 50).astype(np.float32)
    got = mesh_sort(sharded(mesh, "x", jnp.asarray(f)), mesh=mesh,
                    total_order=True)
    np.testing.assert_array_equal(np.asarray(got), np.sort(f))


@pytest.mark.parametrize("n_dev", [1, 8])
def test_mesh_sort_check_order(rng, n_dev):
    """Distributed early-exit gate: sorted input
    passes through byte-exact; unsorted input — including disorder confined
    to a single shard boundary — still sorts to golden."""
    mesh = make_mesh(n_dev)
    n = 4096
    values = np.arange(n, dtype=np.uint32)

    srt = np.sort(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    gk, gv = mesh_sort(
        sharded(mesh, "x", jnp.asarray(srt)),
        sharded(mesh, "x", jnp.asarray(values)),
        mesh=mesh, check_order=True,
    )
    np.testing.assert_array_equal(np.asarray(gk), srt)
    np.testing.assert_array_equal(np.asarray(gv), values)

    # disorder ONLY at a shard boundary: per-shard checks alone would pass
    bad = srt.copy()
    half = n // 2
    bad[half - 1], bad[half] = bad[half], bad[half - 1]
    if bad[half - 1] == bad[half]:
        bad[half - 1] += 1  # ensure a real inversion
    gk = mesh_sort(sharded(mesh, "x", jnp.asarray(bad)), mesh=mesh,
                   check_order=True)
    np.testing.assert_array_equal(np.asarray(gk), golden_sort(bad))

    rnd = rng.integers(0, 2**10, size=n, dtype=np.uint32)  # dupes: stability
    gk, gv = mesh_sort(
        sharded(mesh, "x", jnp.asarray(rnd)),
        sharded(mesh, "x", jnp.asarray(values)),
        mesh=mesh, check_order=True,
    )
    rk, rv = golden_sort(rnd, values)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)


def test_mesh_sort_check_order_gate_actually_fires(rng, monkeypatch):
    """Round-3 advisor: output equality alone cannot distinguish "gate took
    the passthrough" from "gate re-sorted sorted input" (identical bytes).
    Poison the sort branch at runtime: if the early exit ever stops firing
    on sorted input, the poisoned branch corrupts the output and this test
    fails — `lax.cond` executes only the taken branch."""
    import importlib

    # the function export in parallel/__init__ shadows the submodule attr
    ms_mod = importlib.import_module("tpu_radix_sort.parallel.mesh_sort")

    mesh = make_mesh(4)
    n = 2048
    real = ms_mod._shard_sort

    def poisoned(arrs, **kw):
        return tuple(a ^ jnp.uint32(0xDEAD) for a in real(arrs, **kw))

    monkeypatch.setattr(ms_mod, "_shard_sort", poisoned)
    # the sort core is jitted: drop cached clean programs so the poisoned
    # body is traced, and clear again so no poisoned program leaks out
    jax.clear_caches()
    try:
        srt = np.sort(rng.integers(0, 2**32, size=n, dtype=np.uint32))
        got = mesh_sort(sharded(mesh, "x", jnp.asarray(srt)), mesh=mesh,
                        check_order=True)
        np.testing.assert_array_equal(np.asarray(got), srt)  # gate fired
        # sanity: unsorted input takes the (poisoned) sort branch
        rnd = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        got = mesh_sort(sharded(mesh, "x", jnp.asarray(rnd)), mesh=mesh,
                        check_order=True)
        assert not np.array_equal(np.asarray(got), golden_sort(rnd))
    finally:
        jax.clear_caches()


def test_mesh_sort_check_order_jits(rng):
    mesh = make_mesh(4)
    srt = np.sort(rng.integers(0, 2**32, size=2048, dtype=np.uint32))
    f = jax.jit(lambda k: mesh_sort(k, mesh=mesh, check_order=True))
    got = f(sharded(mesh, "x", jnp.asarray(srt)))
    np.testing.assert_array_equal(np.asarray(got), srt)


def test_mesh_sort_jit_sharded(rng):
    """The whole mesh sort jits end-to-end with sharded inputs."""
    mesh = make_mesh(8)
    n = 1 << 13
    keys = jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    f = jax.jit(lambda k: mesh_sort(k, mesh=mesh))
    got = f(sharded(mesh, "x", keys))
    np.testing.assert_array_equal(np.asarray(got), golden_sort(np.asarray(keys)))


def test_public_sort_mesh_routing(rng, monkeypatch):
    """`trs.sort(..., mesh=)` is the single distributed entrypoint: auto
    routes by device count (compare-split <= 4 devices, exchange above),
    explicit method names force a
    strategy, and results match golden either way."""
    import tpu_radix_sort as trs
    from tpu_radix_sort import parallel as par

    calls = []

    def spy(name, real):
        def wrapped(*a, **kw):
            calls.append(name)
            return real(*a, **kw)
        return wrapped

    # ops.sort resolves parallel.mesh_sort / parallel.exchange_sort at call
    # time, so patching the parallel package attrs intercepts the routing
    monkeypatch.setattr(par, "mesh_sort", spy("mesh", par.mesh_sort))
    monkeypatch.setattr(par, "exchange_sort",
                        spy("exchange", par.exchange_sort))

    n = 4096
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)

    mesh8 = make_mesh(8)
    got = trs.sort(sharded(mesh8, "x", jnp.asarray(keys)), mesh=mesh8)
    np.testing.assert_array_equal(np.asarray(got), golden_sort(keys))
    assert calls[-1] == "exchange"

    mesh4 = make_mesh(4)
    got = trs.sort(sharded(mesh4, "x", jnp.asarray(keys)), mesh=mesh4)
    np.testing.assert_array_equal(np.asarray(got), golden_sort(keys))
    assert calls[-1] == "mesh"

    got = trs.sort(sharded(mesh8, "x", jnp.asarray(keys)), mesh=mesh8,
                   method="mesh")
    np.testing.assert_array_equal(np.asarray(got), golden_sort(keys))
    assert calls[-1] == "mesh"

    with pytest.raises(ValueError, match="mesh"):
        trs.sort(jnp.asarray(keys), mesh=mesh8, method="radix")


def test_public_sort_mesh_kv_options(rng):
    """Routed path carries the full option surface (count/bit_count/
    descending/values) with single-chip semantics."""
    import tpu_radix_sort as trs

    mesh = make_mesh(8)
    n, count = 5000, 4321
    keys = rng.integers(0, 2**8, size=n, dtype=np.uint32)
    values = np.arange(n, dtype=np.uint32)
    gk, gv = trs.sort(
        sharded(mesh, "x", jnp.asarray(keys)),
        sharded(mesh, "x", jnp.asarray(values)),
        mesh=mesh, count=count, bit_count=8, descending=True,
    )
    rk, rv = golden_sort(keys, values, count=count, bit_count=8,
                         descending=True)
    np.testing.assert_array_equal(np.asarray(gk), rk)
    np.testing.assert_array_equal(np.asarray(gv), rv)


def test_argsort_over_mesh(rng):
    """argsort routes through sort(mesh=) (iota payload co-moved as a
    generic value distributed; the rank-payload fast path is single-chip
    only) and returns global stable ranks."""
    import tpu_radix_sort as trs

    mesh = make_mesh(8)
    n = 2048
    keys = rng.integers(0, 97, size=n, dtype=np.uint64).astype(np.uint32)
    order = trs.argsort(sharded(mesh, "x", jnp.asarray(keys)), mesh=mesh)
    np.testing.assert_array_equal(
        np.asarray(order), np.argsort(keys, kind="stable").astype(np.uint32))
