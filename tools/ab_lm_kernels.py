#!/usr/bin/env python3
"""Two checkouts of the port, A and B, on one CUDA card: the LM prefill
kernels (K6 flash_attention, K7 ssd_chunk) and the backwards of K6
(flash_attention_bwd) and K7 (ssd_chunk_bwd) at chip_smoke.py phase 7's
timed shapes, outputs compared bit for bit and device times taken in turns
A, B, B, A.  Where a backward's outputs differ (a changed order of
summation), B's are held at phase 7's bars: K6's to A's
(chip_smoke.k6_bwd_close with its noise floor), K7's to its plain
version on the same inputs (chip_smoke.k7_bwd_close with k7_bwd_noise);
the run fails if one misses.  Where an fp32 forward's outputs differ,
B's are held to the plain version on the same inputs at phase 7's bars
(K6_FP32_RTOL, K7_FP32_RTOL); a bf16 row must be bit-identical.  Beside
each fp32 row's times the yardstick the rows are judged by, timed in
every run the same way: SDPA's fp32 forward, or its backward
(chip_smoke.library_backward_ms), for K6, the plain version for K7.

  python3 tools/ab_lm_kernels.py --a OLD_CHECKOUT --b NEW_CHECKOUT

Each checkout's extension is built in its own ``build/torch_kernels`` (the
two builds run at once), and each run is a process of its own that imports
``repro_torch`` from that checkout's ``src`` and calls only the public
wrappers, so two versions whose bindings differ still compare.  Inputs
come from a CUDA generator seeded per shape, the same in every run.
Device time per call is chip_smoke.device_ms's CUDA-graph replay.
Prints one line per shape and the card's name and power limit; exits
non-zero if a run fails or there is no card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

SHAPES = (
    # (kernel, dtype, shape, flag): K6 (B, H, S, D), or (B, H, KV, S, D)
    # with KV heads, causal or not, "lse" causal with the lse as a train
    # step runs it; K7 (BC, Q, H, P, N) with stride-0 B/C
    *[("flash_attention", "bfloat16", (1, 32, s, 64), causal)
      for causal in (True, False) for s in (128, 512, 1024, 2048)],
    ("flash_attention", "float32", (1, 32, 2048, 64), True),
    # qwen2-moe-a2.7b's prefill and granite-3-2b's training attention
    ("flash_attention", "float32", (1, 16, 2048, 128), True),
    ("flash_attention", "float32", (1, 32, 8, 2048, 64), "lse"),
    *[("ssd_chunk", "bfloat16", (bc, 128, 64, 64, 64), True)
      for bc in (1, 4, 8, 16)],
    ("ssd_chunk", "float32", (16, 128, 64, 64, 64), True),
    # mamba2-2.7b's prefill
    ("ssd_chunk", "float32", (16, 128, 80, 64, 128), True),
    # K6's backward: (B, H, KV, S, D, Sk, causal, window)
    *[("flash_attention_bwd", "bfloat16", shape, name)
      for name, shape in (
          ("granite-3-2b train", (1, 32, 8, 2048, 64, 2048, True, 0)),
          ("zamba2-1.2b train", (1, 32, 32, 2048, 64, 2048, True, 0)),
          ("qwen3-14b", (1, 40, 8, 2048, 128, 2048, True, 0)),
          ("seamless-m4t-large-v2 cross-attention",
           (1, 16, 16, 512, 64, 1024, False, 0)),
          ("window 1000", (1, 32, 32, 4096, 64, 4096, True, 1000)))],
    ("flash_attention_bwd", "float32", (1, 32, 8, 2048, 64, 2048, True, 0),
     "granite-3-2b train"),
    # K7's backward: (BC, Q, H, P, N), one B/C group broadcast to the heads
    *[("ssd_chunk_bwd", dtype, shape, name)
      for dtype in ("bfloat16", "float32")
      for name, shape in (("zamba2-1.2b train", (16, 128, 64, 64, 64)),
                          ("mamba2-2.7b train", (16, 128, 80, 64, 128)))],
)


def label(kernel: str, dtype: str, shape: tuple, flag) -> str:
    if kernel == "flash_attention":
        return (f"K6 {shape} {dtype} "
                f"{'causal, lse' if flag == 'lse' else 'causal' if flag else 'full'}")
    if kernel == "flash_attention_bwd":
        return f"K6 bwd {flag} {dtype}"
    if kernel == "ssd_chunk_bwd":
        return f"K7 bwd {flag} {dtype}"
    return f"K7 BC={shape[0]} {shape[1:]} {dtype} stride-0 b/c"


def worker(root: str, save: str | None) -> None:
    """Build (``save`` None) or run every shape and save outputs and ms."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import (device_ms, k6_bwd_inputs, k6_bwd_library,
                            k6_bwd_noise, k7_bwd_inputs, k7_bwd_noise,
                            library_backward_ms)

    sys.path.insert(0, os.path.join(root, "src"))   # ahead of this repo's
    import torch

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_bwd

    assert _build.BUILD_DIR.is_relative_to(os.path.realpath(root)), root
    _build.extension()
    if save is None:
        return
    dev = torch.device("cuda", 0)
    results = []
    for i, (kernel, dtype, shape, flag) in enumerate(SHAPES):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        dt = getattr(torch, dtype)

        def rand(*s, dt=dt):
            return torch.randn(*s, generator=gen, device=dev).to(dt)

        noise = plain = yard = None
        if kernel == "ssd_chunk_bwd":
            x, dt_a, b_, c_, *cots = k7_bwd_inputs(torch, dev, gen, (*shape, 1),
                                                   dt)
            fn = lambda a=(x, dt_a, b_, c_, *cots): ssd_chunk_bwd(*a, 1)  # noqa: E731
            noise = k7_bwd_noise(x, b_, c_, *cots)
            plain = [t.cpu() for t in ref.ssd_chunk_bwd_ref(x, dt_a, b_, c_,
                                                            *cots, 1)]
            if dt == torch.float32:
                yard = device_ms(lambda: ref.ssd_chunk_bwd_ref(
                    x, dt_a, b_, c_, *cots, 1), iters=2, replays=3)
        elif kernel == "flash_attention":
            b, h, kv, s, d = shape if len(shape) == 5 else (*shape[:2],
                                                           *shape[1:])
            q = rand(b, s, h, d).transpose(1, 2)
            k, v = (rand(b, s, kv, d).transpose(1, 2) for _ in range(2))
            if flag == "lse":
                fn = lambda q=q, k=k, v=v: flash_attention(  # noqa: E731
                    q, k, v, True, lse=True)
            else:
                fn = lambda q=q, k=k, v=v: (flash_attention(  # noqa: E731
                    q, k, v, flag),)
            if dt == torch.float32:
                plain = [t.cpu() for t in ref.flash_attention_lse_ref(
                    q, k, v, bool(flag))][:len(fn())]
                yard = device_ms(lambda: torch.nn.functional.
                                 scaled_dot_product_attention(
                                     q, k, v, is_causal=bool(flag),
                                     enable_gqa=kv != h), iters=5)
        elif kernel == "flash_attention_bwd":
            q, k, v, do, o, lse = k6_bwd_inputs(torch, dev, gen, shape, dt)
            causal, window = shape[6], shape[7]
            fn = lambda a=(q, k, v, o, do, lse): flash_attention_bwd(  # noqa: E731
                *a, causal, window)
            noise = k6_bwd_noise(q, k, v, do)
            if dt == torch.float32:
                yard = library_backward_ms(*k6_bwd_library(
                    torch, q, k, v, do, causal, window))
        else:
            bc, q, h, p, n = shape
            x = rand(bc, q, h, p)
            dt_a = -rand(bc, q, h, dt=torch.float32).abs() * 0.3
            b_ = rand(bc, q, 1, n).expand(bc, q, h, n)
            c_ = rand(bc, q, 1, n).expand(bc, q, h, n)
            fn = lambda x=x, a=dt_a, b=b_, c=c_: ssd_chunk(x, a, b, c)  # noqa: E731
            if dt == torch.float32:
                plain = [t.cpu() for t in ref.ssd_chunk_ref(x, dt_a, b_, c_)]
                yard = device_ms(lambda: ref.ssd_chunk_ref(x, dt_a, b_, c_),
                                 iters=2, replays=3)
        outs = [t.cpu() for t in fn()]
        results.append((outs, device_ms(fn, iters=5), noise, plain, yard))
    torch.save(results, save)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", help="checkout A (e.g. the parent commit)")
    ap.add_argument("--b", help="checkout B (e.g. the change)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.save)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_lm_kernels: no CUDA card", file=sys.stderr)
        return 1
    me = os.path.abspath(__file__)
    roots = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    builds = [subprocess.Popen([sys.executable, me, "--worker", r])
              for r in roots.values()]
    if any(p.wait() != 0 for p in builds):
        print("ab_lm_kernels: a build failed", file=sys.stderr)
        return 1
    runs = {"A": [], "B": []}
    with tempfile.TemporaryDirectory() as tmp:
        for n, side in enumerate("ABBA"):
            save = os.path.join(tmp, f"{n}.pt")
            subprocess.run([sys.executable, me, "--worker", roots[side],
                            "--save", save], check=True)
            runs[side].append(torch.load(save))
    sys.path.insert(0, os.path.dirname(os.path.dirname(me)))
    from chip_smoke import (K6_FP32_RTOL, K6_LSE_TOL, K7_FP32_RTOL, errors,
                            k6_bwd_close, k7_bwd_close)

    failed = False
    for i, spec in enumerate(SHAPES):
        (outs_a, ms_a1, noise, plain, yard), (_, ms_a2, *_) = (
            runs["A"][0][i], runs["A"][1][i])
        (outs_b, ms_b1, *_), (_, ms_b2, *_) = runs["B"][0][i], runs["B"][1][i]
        same = all(torch.equal(a, b) for a, b in zip(outs_a, outs_b))
        diff = max((a.double() - b.double()).abs().max().item()
                   for a, b in zip(outs_a, outs_b))
        line = (f"{label(*spec):48s} device ms A {ms_a1:.5f} {ms_a2:.5f} | "
                f"B {ms_b1:.5f} {ms_b2:.5f} | A/B "
                f"{(ms_a1 + ms_a2) / (ms_b1 + ms_b2):.3f}x | outputs "
                f"{'bit-identical' if same else f'differ, max abs {diff:.3e}'}")
        if yard is not None:
            yards = [r[i][4] for side in "AB" for r in runs[side]]
            what = {"flash_attention": "SDPA forward",
                    "flash_attention_bwd": "SDPA backward"}.get(spec[0],
                                                                "plain")
            line += f" | {what} ms " + " ".join(f"{y:.5f}" for y in yards)
        if spec[1] == "bfloat16" and not same:
            line += " (a bf16 row must be bit-identical) FAIL"
            failed = True
        elif spec[0] in ("flash_attention", "ssd_chunk") and not same:
            crits, ok = [], True
            for j, (b, w) in enumerate(zip(outs_b, plain)):
                if spec[0] == "flash_attention" and j == 1:   # the lse
                    err = ((b - w).abs() / (1 + w.abs())).max().item()
                    good, bar = err <= K6_LSE_TOL, K6_LSE_TOL
                else:
                    err = errors(b, w)[1]
                    bar = (K6_FP32_RTOL if spec[0] == "flash_attention"
                           else K7_FP32_RTOL)
                    good = err <= bar
                ok = ok and good
                crits.append(f"{err:.2e} (<= {bar:g})")
            line += (f" (B against the plain version: {', '.join(crits)}) "
                     f"{'ok' if ok else 'FAIL'}")
            failed = failed or not ok
        elif spec[0] == "ssd_chunk_bwd" and not same:
            share = max((a != b).double().mean().item()
                        for a, b in zip(outs_a, outs_b))
            ok, _, crit = k7_bwd_close(torch, outs_b, plain, noise)
            line += (f" (B against the plain version: {crit}; up to "
                     f"{100 * share:.2f}% of an output's elements differ from "
                     f"A's) {'ok' if ok else 'FAIL'}")
            failed = failed or not ok
        elif noise is not None and not same:
            notes = []
            for name, a, b, n in zip(("dq", "dk", "dv"), outs_a, outs_b, noise):
                if torch.equal(a, b):
                    notes.append(f"{name} bit-identical")
                    continue
                ok, _, crit = k6_bwd_close(torch, b, a, n)
                share = (a != b).double().mean().item()
                notes.append(f"{name} {100 * share:.2f}% differ, {crit} "
                             f"{'ok' if ok else 'FAIL'}")
                failed = failed or not ok
            line += " (" + "; ".join(notes) + ")"
        print(line)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(out.stdout.strip().splitlines()[0])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
