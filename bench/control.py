"""The readings a cell's correctness limits are set from, beside the
program's own (``bench/run.py`` prints those on every run).

    python bench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed this runs the reference of the cell's configuration three
ways, at the cell's own sizes on the card, and prints the check's numbers
(``bench.check.gaps``) of the last two against the first:

``control``     the reference with every product in fp8 (e4m3 operands, e5m2
                gradients), the nearest precision below the configuration's
                bf16: the control, which must come out not correct;
``half_batch``  the fault of a step that takes the mean over half of its
                batch's rows and leaves the rest out.

A step that returns its state unchanged reads 1 by ``change_gap`` (no
leaf moves) and needs no run.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["readings", "main"]


def readings(bench, cell_name: str, seed: int, device: str) -> dict:
    """{"control": numbers, "half_batch": numbers} of one seed."""
    from bench import traffic as traffic_mod
    from bench.check import gaps, worst_leaves
    from bench.harness import CHECK_STEPS

    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    train = bench.traffic(cell["traffic"])
    ref_mod = bench.reference(cfg["reference"])
    pool = traffic_mod.batches(train, cfg["vocab_size"], seed, device)
    steps = [(b["tokens"], b["labels"]) for b in pool[:CHECK_STEPS]]

    def run(**kw) -> dict:
        return ref_mod.train_steps(cfg, train, seed, steps, device, **kw)

    ref = run()
    out = {}
    for kind, kw in (("control", {"precision": "fp8"}),
                     ("half_batch", {"half_batch": True})):
        got = run(**kw)
        out[kind] = gaps(got, ref)
        print(f"{kind} seed {seed}: losses {got['losses']} reference "
              f"{ref['losses']}; worst leaves {worst_leaves(got, ref)}",
              file=sys.stderr)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    from bench.harness import Bench

    bench = Bench()
    for seed in args.seeds:
        out = readings(bench, args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    sys.exit(main())
