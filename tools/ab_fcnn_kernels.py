#!/usr/bin/env python3
"""Two checkouts of the port, A and B, on one CUDA card: one NN1 training
step (784-1000-500-10, batch 64) as each checkout runs it, in turns A, B,
B, A.

  python3 tools/ab_fcnn_kernels.py --a OLD_CHECKOUT --b NEW_CHECKOUT

For each run: the step's forward and backward (``fcnn.loss_fn`` then
``torch.autograd.grad``) captured in one CUDA graph, device ms per step
from its replay (chip_smoke.device_ms); the same eagerly and the whole
Adam step (``train_fcnn.train_step``) eagerly, from CUDA events, host
cost included (chip_smoke.eager_ms); and the device operations per step
from torch.profiler over 20 steps.  The loss and gradients of one step
from the same parameters are compared across the checkouts.

Each checkout's extension is built in its own ``build/torch_kernels`` (the
two builds run at once), and each run is a process of its own that
imports ``repro_torch`` from that checkout's ``src`` and calls only entry
points both have.  Prints one line per run and the card's name and power
limit; exits non-zero if a run fails or there is no card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

PROFILE_STEPS = 20


def worker(root: str, save: str | None) -> None:
    """Build (``save`` None) or time one NN1 step and save the numbers."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import device_ms, device_rows, eager_ms, nn1_step_parts

    sys.path.insert(0, os.path.join(root, "src"))   # ahead of this repo's
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.launch.train_fcnn import train_step
    from repro_torch.models import fcnn

    assert _build.BUILD_DIR.is_relative_to(os.path.realpath(root)), root
    _build.extension()
    if save is None:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    params, leaves, batch, opt, state, step_t = nn1_step_parts(torch, dev)
    loss = fcnn.loss_fn(params, batch)
    outs = [t.detach().cpu() for t in (loss, *torch.autograd.grad(loss, leaves))]
    # no autograd graph of the default stream may outlive this point: the
    # capture below would have to wait for that stream
    del loss

    def fwd_bwd():
        return torch.autograd.grad(fcnn.loss_fn(params, batch), leaves)

    def step():
        train_step(params, opt, state, batch, step_t)

    numbers = {"graph_ms": device_ms(fwd_bwd, iters=10),
               "eager_ms": eager_ms(fwd_bwd, iters=100),
               "step_ms": eager_ms(step, iters=100)}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    numbers["ops"] = sum(c for _, c, _ in rows) / PROFILE_STEPS
    numbers["busy_ms"] = sum(us for _, _, us in rows) / 1e3 / PROFILE_STEPS
    torch.save((outs, numbers), save)


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
        print("ab_fcnn_kernels: no CUDA card", file=sys.stderr)
        return 1
    me = os.path.abspath(__file__)
    roots = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    builds = [subprocess.Popen([sys.executable, me, "--worker", r])
              for r in roots.values()]
    if any(p.wait() != 0 for p in builds):
        print("ab_fcnn_kernels: a build failed", file=sys.stderr)
        return 1
    runs = {"A": [], "B": []}
    with tempfile.TemporaryDirectory() as tmp:
        for n, side in enumerate("ABBA"):
            save = os.path.join(tmp, f"{n}.pt")
            subprocess.run([sys.executable, me, "--worker", roots[side],
                            "--save", save], check=True)
            outs, numbers = torch.load(save)
            runs[side].append(outs)
            print(f"run {n + 1} {side}: NN1 forward+backward in a CUDA graph "
                  f"{numbers['graph_ms']:.5f} ms device | eager "
                  f"forward+backward {numbers['eager_ms']:.5f} ms | eager Adam "
                  f"step {numbers['step_ms']:.5f} ms | {numbers['ops']:.1f} "
                  f"device operations, busy {numbers['busy_ms']:.5f} ms a step",
                  flush=True)
    names = ["loss"] + [f"grad {k}{i + 1}" for i in range(3) for k in "wb"]
    for name, a, b in zip(names, runs["A"][0], runs["B"][0]):
        diff = (a.double() - b.double()).abs().max().item()
        print(f"{name:8s} A vs B: "
              f"{'bit-identical' if torch.equal(a, b) else f'max abs {diff:.3e}'}")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(out.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
