"""Distributed prefix sum vs the golden oracle, on a virtual 8-device mesh.

The reference's PrefixSumKernel is single-GPU (`src/kernels/
PrefixSumKernel.ts`); this is the mesh lift (per-shard scan + one
all_gather of shard totals, `parallel/scan.py`), tested with the same
oracle style as the single-chip op (`example/tests.ts:288-296`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_radix_sort as trs
from tpu_radix_sort.models.golden import golden_prefix_sum
from tpu_radix_sort.parallel import mesh_prefix_sum, sharded
from jax.sharding import Mesh


def make_mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("x",))


@pytest.mark.parametrize("n_dev,n", [(2, 1000), (8, 5000), (8, 8192)])
def test_mesh_prefix_sum_matches_oracle(rng, n_dev, n):
    mesh = make_mesh(n_dev)
    x = rng.integers(0, 8, size=n, dtype=np.uint32)
    got = mesh_prefix_sum(sharded(mesh, "x", jnp.asarray(x)), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), golden_prefix_sum(x))


def test_mesh_prefix_sum_subcount_and_inclusive(rng):
    mesh = make_mesh(8)
    n, count = 3000, 2345
    x = rng.integers(0, 2**16, size=n, dtype=np.uint32)
    got = mesh_prefix_sum(
        sharded(mesh, "x", jnp.asarray(x)), mesh=mesh, count=count
    )
    np.testing.assert_array_equal(np.asarray(got), golden_prefix_sum(x, count=count))
    # suffix untouched
    np.testing.assert_array_equal(np.asarray(got)[count:], x[count:])

    inc = mesh_prefix_sum(
        sharded(mesh, "x", jnp.asarray(x)), mesh=mesh, inclusive=True
    )
    ref = np.cumsum(x.astype(np.uint64)).astype(np.uint32)
    np.testing.assert_array_equal(np.asarray(inc), ref)


def test_mesh_prefix_sum_wraparound_and_int32(rng):
    mesh = make_mesh(4)
    x = np.full(2048, 0xF000_0000, dtype=np.uint32)  # wraps many times
    got = mesh_prefix_sum(sharded(mesh, "x", jnp.asarray(x)), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), golden_prefix_sum(x))

    xi = rng.integers(-1000, 1000, size=1500, dtype=np.int32)
    got = mesh_prefix_sum(sharded(mesh, "x", jnp.asarray(xi)), mesh=mesh)
    ref = trs.prefix_sum(jnp.asarray(xi))  # single-chip semantics
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_mesh_prefix_sum_routing_and_kernel_class(rng):
    """Public surface: `trs.prefix_sum(mesh=)` and `PrefixSumKernel(mesh=)`
    route to the distributed scan."""
    mesh = make_mesh(8)
    n = 4096
    x = rng.integers(0, 100, size=n, dtype=np.uint32)
    got = trs.prefix_sum(sharded(mesh, "x", jnp.asarray(x)), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), golden_prefix_sum(x))

    kern = trs.PrefixSumKernel(count=n, mesh=mesh)
    got = kern.dispatch(sharded(mesh, "x", jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(got), golden_prefix_sum(x))


def test_mesh_prefix_sum_jits(rng):
    mesh = make_mesh(8)
    x = rng.integers(0, 100, size=2048, dtype=np.uint32)
    f = jax.jit(lambda a: mesh_prefix_sum(a, mesh=mesh))
    got = f(sharded(mesh, "x", jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(got), golden_prefix_sum(x))
