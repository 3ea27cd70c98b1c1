"""Sort integrity matrix vs the golden model.

Mirrors the reference's randomized sweep (`example/tests.ts:9-107`):
element counts across decades with jitter, random sub-counts, random flags,
keys-only and key+value, uint32/float32/int32 keys, bit_count 4..32, and
the extensions (descending, total order, wide payloads). The full-size
runs live in chip_smoke.py and bench.py on the GPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_radix_sort as trs
from tpu_radix_sort.models.golden import golden_sort

KEY_DTYPES = ["uint32", "float32", "int32"]


def _rand_keys(rng, n, dtype="uint32", lo=0, hi=2**32):
    if dtype == "uint32":
        return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)
    if dtype == "float32":
        return (rng.random(n) * 1e6).astype(np.float32)  # non-negative
    if dtype == "int32":
        return rng.integers(0, min(hi, 2**31), n).astype(np.int32)
    raise ValueError(dtype)


def _payload(rng, n, kind):
    if kind == "u32":
        return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "f32":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "i32":
        return rng.integers(-(2**31), 2**31, n).astype(np.int32)
    if kind == "iota":
        return np.arange(n, dtype=np.uint32)
    raise ValueError(kind)


@pytest.mark.parametrize("dtype", KEY_DTYPES)
@pytest.mark.parametrize("n", [1, 2, 100, 127, 128, 129, 1000, 3333])
def test_keys_only(rng, dtype, n):
    k = _rand_keys(rng, n, dtype)
    out = np.asarray(trs.sort(jnp.asarray(k)))
    assert np.array_equal(out, golden_sort(k))


@pytest.mark.parametrize("payload", ["u32", "f32", "i32", "iota"])
@pytest.mark.parametrize("n", [100, 1000, 3333])
def test_key_value(rng, payload, n):
    k = _rand_keys(rng, n, hi=max(2, n // 3))  # many duplicates: stability
    v = _payload(rng, n, payload)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v))
    rk, rv = golden_sort(k, v)
    assert np.array_equal(np.asarray(ok), rk)
    assert np.array_equal(np.asarray(ov).view(np.uint32), rv.view(np.uint32))


@pytest.mark.parametrize("n", [100, 1000, 3333])
def test_key_value_u64_payload(rng, x64, n):
    k = _rand_keys(rng, n, hi=max(2, n // 3))
    v = rng.integers(0, 2**64, n, dtype=np.uint64)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v))
    rk, rv = golden_sort(k, v)
    assert np.array_equal(np.asarray(ok), rk)
    assert np.array_equal(np.asarray(ov), rv)


@pytest.mark.parametrize("dtype", KEY_DTYPES)
def test_subcount(rng, dtype):
    # sort a random prefix of a larger buffer (example/tests.ts:31,56)
    n = 3333
    k = _rand_keys(rng, n, dtype)
    v = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    for count in [0, 1, 17, 1000, n]:
        ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v), count=count)
        rk, rv = golden_sort(k, v, count=count)
        assert np.array_equal(np.asarray(ok), rk), count
        assert np.array_equal(np.asarray(ov), rv), count


@pytest.mark.parametrize("dtype", KEY_DTYPES)
@pytest.mark.parametrize("bit_count", [4, 8, 16, 20, 28, 32])
def test_bit_count(rng, dtype, bit_count):
    n = 3333
    k = _rand_keys(rng, n, dtype)
    v = np.arange(n, dtype=np.uint32)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v), bit_count=bit_count)
    rk, rv = golden_sort(k, v, bit_count=bit_count)
    assert np.array_equal(np.asarray(ok), rk)
    assert np.array_equal(np.asarray(ov), rv)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", ["uint32", "int32"])
def test_bit_count_keys_only_is_stable(rng, dtype, descending):
    # keys-only with masked high bits still requires stable full-key output
    k = np.array([0x35, 0x25, 0x15, 0x05, 0x14, 0x24], dtype=dtype)
    out = np.asarray(trs.sort(jnp.asarray(k), bit_count=4,
                              descending=descending))
    assert np.array_equal(out, golden_sort(k, bit_count=4,
                                           descending=descending))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_signed_keys_total_order(rng, dtype, descending):
    # beyond the reference: negative floats and int32 in true numeric order
    n = 3333
    if dtype == "float32":
        k = (rng.random(n) * 100 - 50).astype(np.float32)
    else:
        k = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    k[: n // 4] = k[0]  # equal-key run: stability
    v = np.arange(n, dtype=np.uint32)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v), total_order=True,
                      descending=descending)
    rk, rv = golden_sort(k, v, total_order=True, descending=descending)
    assert np.array_equal(np.asarray(ok), rk)
    assert np.array_equal(np.asarray(ov), rv)


def test_float32_values_payload(rng):
    n = 1000
    k = _rand_keys(rng, n)
    v = rng.random(n).astype(np.float32)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v))
    rk, rv = golden_sort(k, v)
    assert np.array_equal(np.asarray(ok), rk)
    assert np.array_equal(np.asarray(ov), rv)


@pytest.mark.parametrize("payload", [None, "u32", "f32"])
def test_check_order_on_sorted_input(rng, payload):
    n = 1000
    k = np.sort(_rand_keys(rng, n))
    if payload is None:
        out = trs.sort(jnp.asarray(k), check_order=True)
        assert np.array_equal(np.asarray(out), k)
        return
    v = _payload(rng, n, payload)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v), check_order=True)
    rk, rv = golden_sort(k, v)
    assert np.array_equal(np.asarray(ok), rk)
    assert np.array_equal(np.asarray(ov), rv)


@pytest.mark.parametrize("payload", [None, "u32", "f32"])
def test_check_order_on_unsorted_input(rng, payload):
    n = 1000
    k = _rand_keys(rng, n, hi=300)
    if payload is None:
        out = trs.sort(jnp.asarray(k), check_order=True)
        assert np.array_equal(np.asarray(out), golden_sort(k))
        return
    v = _payload(rng, n, payload)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v), check_order=True)
    rk, rv = golden_sort(k, v)
    assert np.array_equal(np.asarray(ok), rk)
    assert np.array_equal(np.asarray(ov), rv)


def test_check_order_keys_only(rng):
    k = np.sort(_rand_keys(rng, 1000))
    out = np.asarray(trs.sort(jnp.asarray(k), check_order=True))
    assert np.array_equal(out, golden_sort(k))


def test_total_order_extension(rng):
    # beyond the reference: negative floats and int32 in true numeric order
    f = (rng.random(1000) * 100 - 50).astype(np.float32)
    out = np.asarray(trs.sort(jnp.asarray(f), total_order=True))
    assert np.array_equal(out, np.sort(f))
    i = rng.integers(-(2**31), 2**31, 1000, dtype=np.int64).astype(np.int32)
    out = np.asarray(trs.sort(jnp.asarray(i), total_order=True))
    assert np.array_equal(out, np.sort(i))


def test_argsort(rng):
    k = _rand_keys(rng, 1000, hi=100)
    idx = np.asarray(trs.argsort(jnp.asarray(k)))
    assert np.array_equal(idx, np.argsort(k, kind="stable").astype(np.uint32))


def test_sort_packed_2d(rng):
    # texture-kernel parity: 2-D packed (key, value) records, row-major order
    h, w = 16, 128
    k = _rand_keys(rng, h * w, hi=1000)
    v = np.arange(h * w, dtype=np.uint32)
    packed = np.stack([k, v], axis=-1).reshape(h, w, 2)
    out = np.asarray(trs.sort_packed(jnp.asarray(packed)))
    rk, rv = golden_sort(k, v)
    assert np.array_equal(out.reshape(-1, 2)[:, 0], rk)
    assert np.array_equal(out.reshape(-1, 2)[:, 1], rv)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_matrix(seed):
    # compressed version of the reference's random sweep
    rng = np.random.default_rng(seed)
    windows = [(100, 128), (900, 1024), (3000, 4096)]
    for i in range(8):
        lo, hi = windows[i % len(windows)]
        n = int(rng.integers(lo, hi + 1))
        count = n if rng.integers(0, 2) else int(rng.integers(lo, n + 1))
        bit_count = int(rng.choice([8, 16, 32]))
        dtype = str(rng.choice(["uint32", "float32"]))
        with_values = bool(rng.integers(0, 2))
        check_order = bool(rng.integers(0, 2))
        descending = bool(rng.integers(0, 2))
        k = _rand_keys(rng, n, dtype=dtype)
        kj = jnp.asarray(k)
        cfg = (n, count, bit_count, dtype, check_order, descending)
        if with_values:
            v = np.arange(n, dtype=np.uint32)
            ok, ov = trs.sort(kj, jnp.asarray(v), count=count,
                              bit_count=bit_count, check_order=check_order,
                              descending=descending)
            rk, rv = golden_sort(k, v, count=count, bit_count=bit_count,
                                 descending=descending)
            assert np.array_equal(np.asarray(ok), rk), cfg
            assert np.array_equal(np.asarray(ov), rv), cfg
        else:
            out = trs.sort(kj, count=count, bit_count=bit_count,
                           check_order=check_order, descending=descending)
            ref = golden_sort(k, count=count, bit_count=bit_count,
                              descending=descending)
            assert np.array_equal(np.asarray(out), ref), cfg


def test_input_validation():
    # uint8 is outside the key-dtype surface (16-bit keys are supported)
    with pytest.raises(TypeError):
        trs.sort(jnp.zeros(8, jnp.uint8))
    with pytest.raises(ValueError):
        trs.sort(jnp.zeros((2, 4), jnp.uint32))
    with pytest.raises(ValueError):
        trs.sort(jnp.zeros(8, jnp.uint32), bit_count=7)
    with pytest.raises(ValueError):
        trs.sort(jnp.zeros(8, jnp.uint32), count=9)
    with pytest.raises(ValueError):
        trs.sort(jnp.zeros(8, jnp.uint32), jnp.zeros(4, jnp.uint32))
    with pytest.raises(ValueError):
        trs.sort(jnp.zeros(8, jnp.uint32), method="bogus")
    # 64-bit host arrays with x64 off would be silently truncated by
    # asarray: every 64-bit-accepting entrypoint must refuse instead
    k64 = np.zeros(8, np.uint64)
    for fn in (lambda: trs.sort(k64),
               lambda: trs.argsort(k64),
               lambda: trs.sort_batched(k64.reshape(2, 4)),
               lambda: trs.sort_segments(k64, jnp.asarray([0, 8])),
               lambda: trs.is_sorted(k64),
               lambda: trs.disorder_count(k64)):
        with pytest.raises(TypeError, match="x64"):
            fn()


@pytest.mark.parametrize("method", ["auto", "xla"])
def test_methods_accepted(rng, method):
    k = _rand_keys(rng, 500, hi=50)
    v = np.arange(500, dtype=np.uint32)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v), method=method)
    rk, rv = golden_sort(k, v)
    assert np.array_equal(np.asarray(ok), rk)
    assert np.array_equal(np.asarray(ov), rv)


@pytest.mark.parametrize("method", ["bitonic", "radix"])
def test_removed_methods_refused(method):
    k = jnp.zeros(8, jnp.uint32)
    for fn in (lambda: trs.sort(k, method=method),
               lambda: trs.argsort(k, method=method),
               lambda: trs.sort_batched(k.reshape(2, 4), method=method),
               lambda: trs.sort_segments(k, jnp.asarray([0, 8]),
                                         method=method)):
        with pytest.raises(ValueError, match="method"):
            fn()


def test_iota_payload_heavy_duplicates(rng):
    """The argsort payload under heavy key duplication — the case where a
    wrong tie-break shows immediately — with masking and a sub-count."""
    n = 5000
    k = _rand_keys(rng, n, hi=40)  # ~125 duplicates per key
    v = np.arange(n, dtype=np.uint32)
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    rk, rv = golden_sort(k, v)
    ok, ov = trs.sort(kj, vj)
    assert np.array_equal(np.asarray(ok), rk)
    assert np.array_equal(np.asarray(ov), rv)
    # masked bit_count (full key rides as an extra payload)
    rk8, rv8 = golden_sort(k, v, bit_count=8)
    ok8, ov8 = trs.sort(kj, vj, bit_count=8)
    assert np.array_equal(np.asarray(ok8), rk8)
    assert np.array_equal(np.asarray(ov8), rv8)
    # sub-count sort: suffix untouched, prefix stable
    c = 3000
    rkc, rvc = golden_sort(k, v, count=c)
    okc, ovc = trs.sort(kj, vj, count=c)
    assert np.array_equal(np.asarray(okc), rkc)
    assert np.array_equal(np.asarray(ovc), rvc)


def test_iota_payload_descending(rng):
    n = 2048
    k = _rand_keys(rng, n, hi=30)
    v = np.arange(n, dtype=np.uint32)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v), descending=True)
    # stable descending golden: argsort of flipped keys
    order = np.argsort(0xFFFFFFFF - k.astype(np.uint64), kind="stable")
    assert np.array_equal(np.asarray(ok), k[order])
    assert np.array_equal(np.asarray(ov), v[order])


def test_max_keys_with_payload(rng):
    """Real elements with key 0xFFFFFFFF keep their stable order."""
    n = 1000
    k = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    k[rng.integers(0, n, 200)] = _rand_keys(rng, 200)
    v = np.arange(n, dtype=np.uint32)
    ok, ov = trs.sort(jnp.asarray(k), jnp.asarray(v))
    rk, rv = golden_sort(k, v)
    assert np.array_equal(np.asarray(ok), rk)
    assert np.array_equal(np.asarray(ov), rv)
