#!/usr/bin/env python3
"""The K6 backward's schedule choices, timed on one CUDA card: at
chip_smoke.py phase 7's timed shapes (``K6_BWD_SHAPES``), the fused
kernel (bf16: 128-key spans on wgmma; ``--dtype float32``: 64-key spans,
3xTF32 on mma.sync) run with the unit list ``bwd_schedule`` picks and
with variants of it, each variant's gradients held to the plain version
at phase 7's bars (``k6_bwd_close``) and its repeats bit for bit:

  * dQ's slots (``BwdSchedule.slots``, chosen within ``BWD_DQ_BYTES``):
    1, 2, 4, 8 (fp32 also 16 and 32), as far as a tile has parts, at the
    chosen walk slices;
  * the walks cut at every slice height n_qt / k (k = 1..8), the heights
    among which causal walks are cut to ``BWD_UNITS_PER_SM`` units an SM,
    at the chosen slots.

  python3 tools/k6_bwd_sched.py [--dtype float32] [--shapes NAME ...]

Device time per call is chip_smoke.device_ms's CUDA-graph replay.  Prints
one line per variant and the card's name and power limit; exits non-zero
if a variant misses its bars or there is no card.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def heights(fa, shape) -> list[int]:
    """The slice heights n_qt / k, k = 1..8, at ``shape``."""
    n_qt = math.ceil(shape[3] / fa.BWD_TILE)
    return sorted({math.ceil(n_qt / k) for k in range(1, 9)}, reverse=True)


def cut(fa, base, shape, tiles: int):
    """``base`` with its walks cut at ``tiles`` query tiles instead."""
    b, h, kv, s, d, sk, causal, window = shape
    lo, hi = fa._kept_spans(s, sk, causal, window, base.span)
    n_sp = math.ceil(sk / base.span)
    return fa._finish(fa._pattern(lo, hi, n_sp, tiles), len(lo), n_sp,
                      b * kv, h // kv, tiles)._replace(slots=base.slots,
                                                       span=base.span)


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="phase 7 shape names (default: all timed shapes)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        print("k6_bwd_sched: no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import (K6_BWD_SHAPES, device_ms, k6_bwd_close,
                            k6_bwd_inputs, k6_bwd_noise)
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    fa = sys.modules["repro_torch.kernels.flash_attention"]
    _build.extension()
    dev = torch.device("cuda", 0)
    chosen_schedule = fa.bwd_schedule
    ok_all = True
    dtype = getattr(torch, args.dtype)
    span = fa.BWD_SPAN if dtype == torch.bfloat16 else fa.BWD_F32_SPAN
    slot_choices = (1, 2, 4, 8) if dtype == torch.bfloat16 else \
        (1, 2, 4, 8, 16, 32)
    try:
        for i, (name, shape) in enumerate(K6_BWD_SHAPES):
            if args.shapes and name not in args.shapes:
                continue
            b, h, kv, s, d, sk, causal, window = shape
            gen = torch.Generator(device=dev).manual_seed(100 + i)
            q, k, v, do, o, lse = k6_bwd_inputs(torch, dev, gen, shape,
                                                dtype)
            want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal,
                                               window)
            noise = k6_bwd_noise(q, k, v, do)
            base = chosen_schedule(b, h, kv, s, sk, d, causal, window, span)
            most = max(base.dq_count)
            variants = [("chosen", base)]
            variants += [(f"slots {n}", base._replace(slots=n))
                         for n in slot_choices if n <= most
                         and n != base.slots]
            variants += [(f"tiles {t}", cut(fa, base, shape, t))
                         for t in heights(fa, shape) if t != base.tiles]
            for label, sched in variants:
                fa.bwd_schedule = lambda *_, sched=sched: sched

                def kern():
                    return flash_attention_bwd(q, k, v, o, do, lse, causal,
                                               window)

                got, again = kern(), kern()
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                crits = [k6_bwd_close(torch, g, w, n)
                         for g, w, n in zip(got, want, noise)]
                ok = same and all(c[0] for c in crits)
                ok_all = ok_all and ok
                ms = device_ms(kern, iters=5)
                print(f"K6 bwd {name:40s} {args.dtype} {label:9s} tiles "
                      f"{sched.tiles:3d} "
                      f"slots {sched.slots} units {sched.n_units:5d} "
                      f"({sched.n_units / fa.BWD_SMS:5.2f} an SM): {ms:.5f} ms "
                      f"{'ok' if ok else 'FAIL'} (repeats "
                      f"{'bit-identical' if same else 'DIFFER'}; max abs "
                      f"{max(c[1] for c in crits):.3e})", flush=True)
                del got, again
            fa.bwd_schedule = chosen_schedule
    finally:
        fa.bwd_schedule = chosen_schedule
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
