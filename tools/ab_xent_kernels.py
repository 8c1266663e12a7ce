#!/usr/bin/env python3
"""Two checkouts of the port, A and B, on one CUDA card: the softmax
cross-entropy kernels (K4 softmax_xent_fwd, K5 softmax_xent_dlogits) at
the FCNN's NN1 shape and at LM loss shapes (B·L, padded vocabulary),
each output held to the plain version, device times taken in turns A, B,
B, A beside F.cross_entropy and the byte bound.

  python3 tools/ab_xent_kernels.py --a OLD_CHECKOUT --b NEW_CHECKOUT

Each checkout's extension is built in its own ``build/torch_kernels`` (the
two builds run at once), and each run is a process of its own that imports
``repro_torch`` from that checkout's ``src`` and calls only the public
wrappers.  Inputs come from a CUDA generator seeded per shape, the same in
every run.  Device time per call is chip_smoke.device_ms's CUDA-graph
replay; K5 takes the loss cotangent g.  Prints one line per shape and the
card's name and power limit; exits non-zero if a run fails, K4's nll,
lse or mean is more than 1e-5 from its plain version, K5's dlogits are
outside chip_smoke.py's element-wise bar (``dlogits_error``), K4's mean
differs between two calls, or there is no card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

SHAPES = (  # (B, C, dtype): NN1, NN5, an FCNN edge, then LM shapes
    (64, 10, "float32"), (64, 10, "bfloat16"), (128, 10, "float32"),
    (3000, 33, "float32"), (2048, 49408, "float32"),
    (4096, 32000, "float32"), (37, 49408, "float32"),
    (2048, 1000, "float32"), (2048, 49408, "bfloat16"),
)
HBM_BYTES_PER_S = 3.35e12
ATOL = 1e-5


def worker(root: str, save: str | None) -> None:
    """Build (``save`` None) or run every shape and save errors and ms."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import (  # puts this repo's own src on the path
        device_ms,
        dlogits_error,
    )

    sys.path.insert(0, os.path.join(root, "src"))   # ahead of it
    import importlib

    import torch

    from repro_torch.kernels import _build, ref

    sx = importlib.import_module("repro_torch.kernels.softmax_xent")
    assert _build.BUILD_DIR.is_relative_to(os.path.realpath(root)), root
    _build.extension()
    if save is None:
        return
    dev = torch.device("cuda", 0)
    results = []
    for i, (b, c, dtype) in enumerate(SHAPES):
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        x = (torch.randn(b, c, generator=gen, device=dev) * 3).to(
            getattr(torch, dtype))
        lab = torch.randint(0, c, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
        g = torch.tensor(0.7, device=dev)
        want = ref.softmax_xent_fwd_ref(x, lab)
        want_dl = ref.softmax_xent_dlogits_ref(x, lab, want[1], g=g)
        out = sx.softmax_xent_fwd(x, lab)
        again = sx.softmax_xent_fwd(x, lab)
        dl = sx.softmax_xent_dlogits(x, lab, want[1], g=g)
        torch.cuda.synchronize()
        err = (max((o.double() - w.double()).abs().max().item()
                   for o, w in zip(out, want)), dlogits_error(dl, want_dl))
        lab64 = lab.long()
        ms = [device_ms(lambda: sx.softmax_xent_fwd(x, lab), iters=10,
                        replays=5),
              device_ms(lambda: sx.softmax_xent_dlogits(x, lab, want[1], g=g),
                        iters=10, replays=5),
              device_ms(lambda: torch.nn.functional.cross_entropy(
                  x, lab64, reduction="none"), iters=10, replays=5)]
        results.append((*err, torch.equal(out[2], again[2]), ms))
        del x, lab, want, want_dl, out, again, dl
        torch.cuda.empty_cache()
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
        print("ab_xent_kernels: no CUDA card", file=sys.stderr)
        return 1
    me = os.path.abspath(__file__)
    roots = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    builds = [subprocess.Popen([sys.executable, me, "--worker", r])
              for r in roots.values()]
    if any(p.wait() != 0 for p in builds):
        print("ab_xent_kernels: a build failed", file=sys.stderr)
        return 1
    runs = {"A": [], "B": []}
    with tempfile.TemporaryDirectory() as tmp:
        for n, side in enumerate("ABBA"):
            save = os.path.join(tmp, f"{n}.pt")
            subprocess.run([sys.executable, me, "--worker", roots[side],
                            "--save", save], check=True)
            runs[side].append(torch.load(save))
    ok = True
    for i, (b, c, dtype) in enumerate(SHAPES):
        e = 4 if dtype == "float32" else 2
        b4 = (e * b * c + 12 * b + 4) / HBM_BYTES_PER_S * 1e3
        b5 = (2 * e * b * c + 8 * b + 4) / HBM_BYTES_PER_S * 1e3
        cells = []
        for side in "AB":
            (e4a, e5a, same1, ms1), (e4b, e5b, same2, ms2) = (
                runs[side][0][i], runs[side][1][i])
            ok = (ok and max(e4a, e4b) <= ATOL and max(e5a, e5b) <= 1
                  and same1 and same2)
            cells.append(f"{side}: K4 {ms1[0]:.5f} {ms2[0]:.5f} K5 "
                         f"{ms1[1]:.5f} {ms2[1]:.5f} err K4 "
                         f"{max(e4a, e4b):.1e} K5 {max(e5a, e5b):.3f} of its "
                         f"bar, mean repeat "
                         f"{'same' if same1 and same2 else 'DIFFERS'}")
        lib = runs["B"][0][i][3][2]
        print(f"({b}, {c}) {dtype:8s} device ms {' | '.join(cells)} | "
              f"F.cross_entropy {lib:.5f} | bound K4 {b4:.5f} K5 {b5:.5f} "
              f"(bytes)")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(out.stdout.strip().splitlines()[0])
    if not ok:
        print("ab_xent_kernels: an output disagrees with its plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
