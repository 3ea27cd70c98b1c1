"""Workload rows on the GPU (BASELINE.json configs 1-3 and 5 on one card,
plus the extensions), each golden-checked in the same run.

Runs through the same phase runner as `chip_smoke.py` (compile, lowering,
golden check, host-clock median over the timed calls, roofline share) and
exits non-zero if any row fails.

    python benchmarks/workloads.py [--seed S]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import tpu_radix_sort as trs  # noqa: E402
from chip_smoke import Phase, _eq, _eq_pair, run_phase  # noqa: E402
from tpu_radix_sort.models import golden as g  # noqa: E402
from tpu_radix_sort.runtime import device as dev  # noqa: E402


def rows(rng):
    # config 1: 256K keys-only (launch overhead dominates)
    n = 1 << 18
    k = rng.integers(0, 2**32, n, dtype=np.uint32)
    ref = g.golden_sort(k)
    yield Phase("256K u32 keys-only", lambda a: trs.sort(a), (k,),
                lambda o: _eq(o, ref), n, 8 * n)

    # config 2 at 4M: key+value
    n = 1 << 22
    k = rng.integers(0, 2**32, n, dtype=np.uint32)
    v = np.arange(n, dtype=np.uint32)
    ref = g.golden_sort(k, v)
    yield Phase("4M u32 key+value", lambda a, b: trs.sort(a, b), (k, v),
                lambda o: _eq_pair(o, ref), n, 16 * n)

    # config 3: 16M f32 sorted input, check_order on (early exit) and off
    n = 1 << 24
    f = np.sort(rng.random(n, dtype=np.float32))
    yield Phase("16M f32 sorted, check_order=True",
                lambda a: trs.sort(a, check_order=True), (f,),
                lambda o: _eq(o, f), n, 8 * n)
    yield Phase("16M f32 sorted, check_order=False", lambda a: trs.sort(a),
                (f,), lambda o: _eq(o, f), n, 8 * n)
    # the losing half of the trade: unsorted input pays the gate
    ku = rng.integers(0, 2**32, n, dtype=np.uint32)
    refu = g.golden_sort(ku)
    yield Phase("16M u32 unsorted, check_order=True",
                lambda a: trs.sort(a, check_order=True), (ku,),
                lambda o: _eq(o, refu), n, 8 * n)
    yield Phase("16M u32 unsorted, check_order=False", lambda a: trs.sort(a),
                (ku,), lambda o: _eq(o, refu), n, 8 * n)

    # config 5 on one card: Zipf(1.3)-skewed keys
    z = rng.zipf(1.3, n).astype(np.uint32)
    refz = g.golden_sort(z)
    yield Phase("16M u32 Zipf(1.3)", lambda a: trs.sort(a), (z,),
                lambda o: _eq(o, refz), n, 8 * n)

    # 16M key+value with a random payload, and argsort
    v = rng.integers(0, 2**32, n, dtype=np.uint32)
    refkv = g.golden_sort(ku, v)
    yield Phase("16M u32 key+value", lambda a, b: trs.sort(a, b), (ku, v),
                lambda o: _eq_pair(o, refkv), n, 16 * n)
    order = np.argsort(ku, kind="stable").astype(np.uint32)
    yield Phase("16M u32 argsort", lambda a: trs.argsort(a), (ku,),
                lambda o: _eq(o, order), n, 8 * n)

    # segmented: ragged Zipf-sized segments vs equal ones vs the batched op
    S = 4096
    w = rng.zipf(1.3, S).astype(np.float64)
    sizes = rng.multinomial(n - S, w / w.sum()) + 1
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    seg_ids = np.repeat(np.arange(S), sizes)
    ref_seg = ku[np.lexsort((ku, seg_ids))]
    yield Phase("16M u32 segmented S=4096 ragged",
                lambda a, o: trs.sort_segments(a, o), (ku, offs),
                lambda o: _eq(o, ref_seg), n, 8 * n)
    S2, L2 = 1024, n // 1024
    offs2 = (np.arange(S2 + 1) * L2).astype(np.int32)
    ref_eq = np.sort(ku.reshape(S2, L2), axis=1)
    yield Phase("16M u32 segmented S=1024 equal",
                lambda a, o: trs.sort_segments(a, o), (ku, offs2),
                lambda o: _eq(o.reshape(S2, L2), ref_eq), n, 8 * n)
    yield Phase("16M u32 batched 1024x16K", lambda a: trs.sort_batched(a),
                (ku.reshape(S2, L2),), lambda o: _eq(o, ref_eq), n, 8 * n)

    # 16-bit keys: bfloat16 with total order
    import ml_dtypes

    kbf = rng.standard_normal(n).astype(ml_dtypes.bfloat16)
    ref_bf = np.sort(kbf).view(np.uint16)
    yield Phase("16M bf16 keys-only total_order",
                lambda a: trs.sort(a, total_order=True), (kbf,),
                lambda o: _eq(np.asarray(o).view(np.uint16), ref_bf),
                n, 4 * n)

    # past the reference's 2^26 ceiling; a non-power-of-two length
    for n, label in (((1 << 26) + (1 << 20), "65M"), (1 << 27, "128M"),
                     (1 << 28, "256M")):
        k = rng.integers(0, 2**32, n, dtype=np.uint32)
        ref = np.sort(k)
        yield Phase(f"{label} u32 keys-only", lambda a: trs.sort(a), (k,),
                    lambda o, ref=ref: _eq(o, ref), n, 8 * n)
        del k, ref

    # 64-bit keys and values (x64 mode inside the row)
    n = 1 << 24
    k64 = rng.integers(0, 2**64, n, dtype=np.uint64)
    ref64 = np.sort(k64)
    yield Phase("16M u64 keys-only", lambda a: trs.sort(a), (k64,),
                lambda o: _eq(o, ref64), n, 16 * n, x64=True)
    kv = rng.integers(0, 2**32, n, dtype=np.uint32)
    vv = rng.integers(0, 2**64, n, dtype=np.uint64)
    refv = g.golden_sort(kv, vv)
    yield Phase("16M u32 keys + u64 values", lambda a, b: trs.sort(a, b),
                (kv, vv), lambda o: _eq_pair(o, refv), n, 24 * n, x64=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    dev.require_gpu()
    dev.enable_compile_cache()
    kind = jax.devices()[0].device_kind
    card = dev.card_lines()[0]
    print(f"device_kind={kind}\n{card}", flush=True)
    failed = []
    for ph in rows(np.random.default_rng(args.seed)):
        try:
            ok = run_phase(ph, kind, card)
        except Exception as e:  # report the row, keep measuring the rest
            print(f"phase={ph.name} ok=False error={type(e).__name__}: {e}",
                  flush=True)
            ok = False
        if not ok:
            failed.append(ph.name)
    if failed:
        print(f"workloads: FAILED rows: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
