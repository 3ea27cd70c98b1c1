"""Smoke run of the public ops on the GPU, each phase checked byte for byte
against `tpu_radix_sort.models.golden` and timed with the host clock.

    python chip_smoke.py              # one card: every op of the main path
    python chip_smoke.py --mesh4      # four cards: trs.sort(mesh=...) only

All phases run in this one process, which must be the only JAX process on
the card. Each phase prints one line: correctness, the sort lowering the
optimized HLO shows (CUB's radix sort or XLA's own sort kernel), the median
and spread over the timed calls, the rate, the least bytes the op must
move and that traffic's share of the card's memory bandwidth, and the card.
The last line of standard output is one JSON object; it is printed only
when every phase passed. Without a GPU the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Any, Callable

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import tpu_radix_sort as trs
from tpu_radix_sort.models import golden
from tpu_radix_sort.runtime import device as dev
from tpu_radix_sort.runtime import time_call

REPS = 10       # timed calls per phase
WARMUP = 2      # untimed calls per phase (the first one also checks output)
N26 = 1 << 26   # the reference's 67,108,864-element maxBufferSize ceiling
N24 = 1 << 24


@dataclasses.dataclass
class Phase:
    name: str
    fn: Callable            # jitted as a whole; positional array args
    args: tuple
    check: Callable[[Any], bool]  # host copy of the output -> golden-exact?
    n: int                  # elements the rate counts
    min_bytes: int          # least device-memory traffic the op needs
    unit: str = "keys/s"
    sorts: bool = True      # report the sort lowering
    x64: bool = False
    cards: int = 1          # cards whose bandwidth the traffic may use


def _eq(a, b) -> bool:
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def _eq_pair(out, ref) -> bool:
    return _eq(out[0], ref[0]) and _eq(out[1], ref[1])


def single_card_phases(rng):
    """The main path: every public op at the size users run it."""
    g = golden
    # 2^26 u32 key+value and keys-only (BASELINE config 2 at the
    # reference's maxBufferSize ceiling); one golden serves both
    k26 = rng.integers(0, 2**32, N26, dtype=np.uint32)
    v26 = np.arange(N26, dtype=np.uint32)
    rk26, rv26 = g.golden_sort(k26, v26)
    yield Phase("sort_kv_u32", lambda k, v: trs.sort(k, v), (k26, v26),
                lambda o: _eq_pair(o, (rk26, rv26)), N26, 16 * N26)
    yield Phase("sort_keys_u32", lambda k: trs.sort(k), (k26,),
                lambda o: _eq(o, rk26), N26, 8 * N26)
    del rk26, rv26

    # non-power-of-two buffer, count < n, masked bit_count=16, with values
    n = 3 * N24 + 1001
    count = n - n // 50
    km = rng.integers(0, 2**32, n, dtype=np.uint32)
    vm = rng.integers(0, 2**32, n, dtype=np.uint32)
    refm = g.golden_sort(km, vm, count=count, bit_count=16)
    yield Phase("sort_kv_count_bits16",
                lambda k, v: trs.sort(k, v, count=count, bit_count=16),
                (km, vm), lambda o: _eq_pair(o, refm), count, 16 * count)
    del km, vm, refm

    # 16M f32 with check_order: sorted input (early exit) and unsorted
    fs = np.sort(rng.random(N24, dtype=np.float32))
    yield Phase("sort_f32_check_order_sorted",
                lambda k: trs.sort(k, check_order=True), (fs,),
                lambda o: _eq(o, fs), N24, 8 * N24)
    fu = rng.random(N24, dtype=np.float32)
    refu = g.golden_sort(fu)
    yield Phase("sort_f32_check_order_unsorted",
                lambda k: trs.sort(k, check_order=True), (fu,),
                lambda o: _eq(o, refu), N24, 8 * N24)
    del fs, fu, refu

    # 64-bit keys under x64: u64 keys + u32 values, int64 total order
    k64 = rng.integers(0, 2**64, N24, dtype=np.uint64)
    v64 = np.arange(N24, dtype=np.uint32)
    ref64 = g.golden_sort(k64, v64)
    yield Phase("sort_kv_u64_keys", lambda k, v: trs.sort(k, v), (k64, v64),
                lambda o: _eq_pair(o, ref64), N24, 24 * N24, x64=True)
    del k64, v64, ref64
    ki = rng.integers(-(2**63), 2**63 - 1, N24, dtype=np.int64)
    refi = g.golden_sort(ki, total_order=True)
    yield Phase("sort_i64_total_order",
                lambda k: trs.sort(k, total_order=True), (ki,),
                lambda o: _eq(o, refi), N24, 16 * N24, x64=True)
    del ki, refi

    # argsort_batched(descending=True): the top-p sampler's sort over
    # 256 rows of 2^17 probabilities
    B, L = 256, 1 << 17
    pb = rng.random((B, L), dtype=np.float32)
    iota = np.arange(L, dtype=np.uint32)
    refb = np.stack([g.golden_sort(row, iota, descending=True)[1]
                     for row in pb])
    yield Phase("argsort_batched_desc_f32",
                lambda k: trs.argsort_batched(k, descending=True), (pb,),
                lambda o: _eq(o, refb), B * L, 8 * B * L)
    del pb, refb

    # sort_segments: 16M keys in 1024 ragged (Zipf-sized) segments + values
    S = 1024
    w = rng.zipf(1.3, S).astype(np.float64)
    sizes = rng.multinomial(N24 - S, w / w.sum()) + 1
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    ks = rng.integers(0, 2**32, N24, dtype=np.uint32)
    vs = rng.integers(0, 2**32, N24, dtype=np.uint32)
    rks, rvs = ks.copy(), vs.copy()
    for a, b in zip(offs[:-1], offs[1:]):
        rks[a:b], rvs[a:b] = g.golden_sort(ks[a:b], vs[a:b])
    yield Phase("sort_segments_kv",
                lambda k, o, v: trs.sort_segments(k, o, v), (ks, offs, vs),
                lambda o: _eq_pair(o, (rks, rvs)), N24, 16 * N24)
    del ks, vs, rks, rvs

    # prefix_sum over 2^26 u32 whose running sum wraps many times
    x = rng.integers(0, 2**32, N26, dtype=np.uint32)
    refx = g.golden_prefix_sum(x)
    yield Phase("prefix_sum_u32", lambda a: trs.prefix_sum(a), (x,),
                lambda o: _eq(o, refx), N26, 8 * N26, unit="elements/s",
                sorts=False)
    # a plain copy at the same size: what a streaming op reaches here
    yield Phase("copy_u32_reference", lambda a: a + np.uint32(1), (x,),
                lambda o: _eq(o, x + np.uint32(1)), N26, 8 * N26,
                unit="elements/s", sorts=False)
    del x, refx

    # is_sorted over 16M+4K sorted keys (a length off every power of two)
    n = N24 + 4096
    s = np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))
    assert g.golden_is_sorted(s)
    yield Phase("is_sorted_u32", lambda a: trs.is_sorted(a), (s,),
                lambda o: bool(o) is True, n, 4 * n, unit="elements/s",
                sorts=False)


def mesh4_phases(rng):
    """trs.sort(mesh=...) over four cards, both strategies, uniform and
    Zipf(1.3) keys, each against golden and one-card trs.sort."""
    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--mesh4 needs 4 devices, found {len(devs)}")
    mesh = Mesh(np.array(devs[:4]), ("x",))
    sh = NamedSharding(mesh, P("x"))
    v = np.arange(N26, dtype=np.uint32)
    for dist in ("uniform", "zipf1.3"):
        if dist == "uniform":
            k = rng.integers(0, 2**32, N26, dtype=np.uint32)
        else:
            k = rng.zipf(1.3, N26).astype(np.uint32)
        ref = golden.golden_sort(k, v)
        one = {}

        def keep_one(o, ref=ref, one=one):
            one["out"] = o
            return _eq_pair(o, ref)

        yield Phase(f"one_card_sort_kv_{dist}", lambda a, b: trs.sort(a, b),
                    (k, v), keep_one, N26, 16 * N26)
        kd, vd = jax.device_put(k, sh), jax.device_put(v, sh)
        for method in ("mesh", "exchange"):
            yield Phase(
                f"mesh4_{method}_sort_kv_{dist}",
                lambda a, b, m=method: trs.sort(a, b, mesh=mesh, method=m),
                (kd, vd),
                lambda o, ref=ref, one=one: (_eq_pair(o, ref)
                                             and _eq_pair(o, one["out"])),
                N26, 16 * N26, cards=4)


def run_phase(ph: Phase, kind: str, card: str) -> bool:
    """Compile, read the lowering, check against golden, time; print the
    phase line and return whether the output was golden-exact."""
    prev_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", ph.x64)
    try:
        t0 = time.perf_counter()
        compiled = jax.jit(ph.fn).lower(*ph.args).compile()
        compile_s = time.perf_counter() - t0
        hlo = compiled.as_text()
        lowering = dev.describe_lowering(hlo) if ph.sorts else "-"
        ragged = "ragged-all-to-all" in hlo
        args = [a if isinstance(a, jax.Array) else jax.device_put(a)
                for a in ph.args]
        ok = ph.check(jax.device_get(compiled(*args)))
        t = time_call(compiled, *args, warmup=WARMUP, reps=REPS)
    finally:
        jax.config.update("jax_enable_x64", prev_x64)
    share = ph.min_bytes / t.median / (dev.hbm_peak(kind) * ph.cards)
    extra = " ragged_all_to_all=real" if ragged else ""
    print(f"phase={ph.name} n={ph.n} ok={ok} lowering={lowering}{extra} "
          f"compile_s={compile_s:.3f} {t.summary_ms()} "
          f"rate={ph.n / t.median:.6e}{ph.unit} min_bytes={ph.min_bytes} "
          f"hbm_share={share:.4%} card=\"{card}\"", flush=True)
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mesh4", action="store_true",
                   help="run only trs.sort(mesh=...) over four cards")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of every generated input")
    args = p.parse_args(argv)

    # phase 0: the device
    try:
        dev.require_gpu()
    except dev.NoAcceleratorError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    cache = dev.enable_compile_cache()
    d0 = jax.devices()[0]
    kind, count = d0.device_kind, len(jax.devices())
    cards = dev.card_lines()
    print(f"device_kind={kind} device_count={count} compile_cache={cache}")
    for line in cards:
        print(line)
    dev.hbm_peak(kind)  # fail now, not after the first phase
    card = cards[0]

    rng = np.random.default_rng(args.seed)
    phases = mesh4_phases(rng) if args.mesh4 else single_card_phases(rng)
    failed = []
    for ph in phases:
        try:
            ok = run_phase(ph, kind, card)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            print(f"phase={ph.name} ok=False error", flush=True)
            ok = False
        if not ok:
            failed.append(ph.name)

    stats = d0.memory_stats() or {}
    print(f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
