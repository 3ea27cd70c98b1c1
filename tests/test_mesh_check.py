"""Distributed order checks vs the single-chip ops, on virtual CPU meshes.

Mesh lift of the reference's CheckSort family (`src/shaders/CheckSort.ts`):
per-shard streaming reductions + one edge `ppermute` + one `psum`
(`parallel/check.py`), exposed through the same public functions via
`mesh=` routing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_radix_sort as trs
from tpu_radix_sort.parallel import (
    mesh_disorder_count,
    mesh_is_sorted,
    sharded,
)
from jax.sharding import Mesh


def make_mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("x",))


@pytest.mark.parametrize("n_dev,n", [(2, 1000), (8, 5000), (8, 8192)])
def test_mesh_disorder_count_matches_single_chip(rng, n_dev, n):
    mesh = make_mesh(n_dev)
    x = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    got = mesh_disorder_count(sharded(mesh, "x", jnp.asarray(x)), mesh=mesh)
    ref = trs.disorder_count(jnp.asarray(x))
    assert int(got) == int(ref)
    # sanity against a numpy count too
    assert int(got) == int(np.sum(x[:-1] > x[1:]))


def test_mesh_disorder_count_count_and_bit_count(rng):
    mesh = make_mesh(8)
    n, count = 5000, 3777
    x = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    got = mesh_disorder_count(
        sharded(mesh, "x", jnp.asarray(x)), mesh=mesh, count=count,
        bit_count=8,
    )
    ref = trs.disorder_count(jnp.asarray(x), count=count, bit_count=8)
    assert int(got) == int(ref)


def test_mesh_is_sorted_cases(rng):
    mesh = make_mesh(8)
    n = 4096
    srt = np.sort(rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32))
    assert bool(mesh_is_sorted(sharded(mesh, "x", jnp.asarray(srt)), mesh=mesh))
    bad = srt.copy()
    bad[n // 2 + 7] = 0  # single inversion strictly inside a middle shard
    assert not bool(
        mesh_is_sorted(sharded(mesh, "x", jnp.asarray(bad)), mesh=mesh)
    )
    # inversion at an exact shard boundary (global index n/8) — only the
    # ppermute'd boundary pair can see it
    bad2 = srt.copy()
    bad2[n // 8] = 0
    assert not bool(
        mesh_is_sorted(sharded(mesh, "x", jnp.asarray(bad2)), mesh=mesh)
    )
    # prefix check: disorder past count is invisible
    assert bool(
        mesh_is_sorted(
            sharded(mesh, "x", jnp.asarray(bad)), mesh=mesh, count=n // 2
        )
    )


def test_mesh_check_float32_and_routing(rng):
    mesh = make_mesh(4)
    x = np.sort(rng.random(2048).astype(np.float32))
    assert bool(trs.is_sorted(sharded(mesh, "x", jnp.asarray(x)), mesh=mesh))
    x[100] = 0.0
    assert not bool(
        trs.is_sorted(sharded(mesh, "x", jnp.asarray(x)), mesh=mesh)
    )
    got = trs.disorder_count(sharded(mesh, "x", jnp.asarray(x)), mesh=mesh)
    ref = trs.disorder_count(jnp.asarray(x))
    assert int(got) == int(ref) == 1


def test_mesh_check_jits(rng):
    mesh = make_mesh(8)
    srt = np.sort(rng.integers(0, 2**32, size=2048, dtype=np.uint64).astype(np.uint32))
    f = jax.jit(lambda a: mesh_is_sorted(a, mesh=mesh))
    assert bool(f(sharded(mesh, "x", jnp.asarray(srt))))
    g = jax.jit(lambda a: mesh_disorder_count(a, mesh=mesh))
    assert int(g(sharded(mesh, "x", jnp.asarray(srt)))) == 0


def test_mesh_check_flags(rng):
    """total_order / descending on the distributed checks: the mesh checks verify the same key views the mesh sorts
    produce, matching single-chip bit-for-bit."""
    mesh = make_mesh(8)
    n = 4096
    f = rng.standard_normal(n).astype(np.float32)
    s_to = np.asarray(trs.sort(jnp.asarray(f), total_order=True))
    assert bool(trs.is_sorted(sharded(mesh, "x", jnp.asarray(s_to)),
                              mesh=mesh, total_order=True))
    assert not bool(trs.is_sorted(sharded(mesh, "x", jnp.asarray(s_to)),
                                  mesh=mesh))
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    s_d = np.sort(k)[::-1].copy()
    assert bool(trs.is_sorted(sharded(mesh, "x", jnp.asarray(s_d)),
                              mesh=mesh, descending=True))
    got = trs.disorder_count(sharded(mesh, "x", jnp.asarray(s_d)),
                             mesh=mesh, descending=True)
    assert int(got) == 0
    # unflagged distributed count matches the single-chip flagged view
    got_up = trs.disorder_count(sharded(mesh, "x", jnp.asarray(s_d)),
                                mesh=mesh)
    ref_up = trs.disorder_count(jnp.asarray(s_d))
    assert int(got_up) == int(ref_up) > 0
    # flags compose with count across shard boundaries
    bad = np.concatenate([s_d[: n // 2], s_d[: n // 2]])
    assert not bool(trs.is_sorted(sharded(mesh, "x", jnp.asarray(bad)),
                                  mesh=mesh, descending=True))
    assert bool(trs.is_sorted(sharded(mesh, "x", jnp.asarray(bad)),
                              mesh=mesh, descending=True, count=n // 2))
