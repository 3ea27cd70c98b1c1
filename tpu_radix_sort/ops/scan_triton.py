"""Reduce-then-scan prefix sum as two Pallas kernels on the Triton route
(the GPU path of `ops/scan.py`).

1. reduce: each program sums its CHUNK-element slice (read 4 B/elem);
2. the block sums' exclusive scan (n / CHUNK elements, `jnp.cumsum`);
3. scan: each program re-reads its slice, scans it TILE by TILE with a
   running carry that starts at its block offset, and writes the result
   (read 4 + write 4 B/elem).

12 B/element in all. On an H100 it beat `jnp.cumsum`'s XLA lowering in 10
of 10 interleaved pairs at 2^24 and 2^26 (PERF.md); TILE, TILES_PER_PROGRAM
and the warp count are the best of the settings tried there. Lengths must
be a multiple of CHUNK (`ops/scan.py` pads).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

TILE = 4096            # elements per vector step inside a program
TILES_PER_PROGRAM = 16
CHUNK = TILE * TILES_PER_PROGRAM
_PARAMS = plt.CompilerParams(num_warps=16, num_stages=1)


def _reduce_kernel(x_ref, o_ref):
    def body(j, acc):
        return acc + jnp.sum(x_ref[pl.ds(j * TILE, TILE)])

    total = jax.lax.fori_loop(0, TILES_PER_PROGRAM, body, jnp.uint32(0))
    o_ref[...] = jnp.full((1,), total, jnp.uint32)


def _scan_kernel(x_ref, off_ref, o_ref, *, inclusive):
    def body(j, carry):
        t = x_ref[pl.ds(j * TILE, TILE)]
        inc = jnp.cumsum(t, dtype=jnp.uint32)
        o_ref[pl.ds(j * TILE, TILE)] = (inc if inclusive else inc - t) + carry
        return carry + jnp.sum(t)

    jax.lax.fori_loop(0, TILES_PER_PROGRAM, body, jnp.sum(off_ref[...]))


@functools.partial(jax.jit, static_argnames=("inclusive", "interpret"))
def scan_u32(u, *, inclusive=False, interpret=False):
    """Prefix sum of a (k * CHUNK,) u32 array, wrapping mod 2^32."""
    n = u.shape[0]
    if n % CHUNK:
        raise ValueError(f"length {n} is not a multiple of {CHUNK}")
    nb = n // CHUNK
    chunk = pl.BlockSpec((CHUNK,), lambda i: (i,))
    one = pl.BlockSpec((1,), lambda i: (i,))
    sums = pl.pallas_call(
        _reduce_kernel,
        out_shape=jax.ShapeDtypeStruct((nb,), jnp.uint32),
        grid=(nb,), in_specs=[chunk], out_specs=one,
        backend="triton", compiler_params=_PARAMS, interpret=interpret,
        name="scan_reduce",
    )(u)
    offsets = jnp.cumsum(sums, dtype=jnp.uint32) - sums
    return pl.pallas_call(
        functools.partial(_scan_kernel, inclusive=inclusive),
        out_shape=jax.ShapeDtypeStruct((n,), jnp.uint32),
        grid=(nb,), in_specs=[chunk, one], out_specs=chunk,
        backend="triton", compiler_params=_PARAMS, interpret=interpret,
        name="scan_blocks",
    )(u, offsets)
