"""One run of one cell of ``BENCHMARK.json``.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run finds everything by name: the cell in ``BENCHMARK.json``, its
configuration's file (the entry's ``file``), its traffic in
``bench/traffic/<traffic>.json``, its correctness limits in
``bench/cells/<cell>.json``, the reference named by the configuration in
``bench/reference/<reference>.py`` and each metric's reader in
``bench/metrics/<metric>.py``.  Adding a configuration, a traffic mix, a
cell or a metric adds files and entries; no file here changes.

A training run:

1. set-up: the program's train step (``bench.program``), the parameters
   drawn from the seed on the card (``reference.make_params``), the batches
   from the seed (``bench.traffic``); the first ``CHECK_STEPS`` steps through
   the window's own call and feed, which warm every shape up and give the
   readings the check judges: each step's loss, each leaf's first gradient
   (from AdamW's first moment) and each leaf's change over those steps;
2. the window: steps back to back, each one's loss and gradient norm read
   back to host floats, until ``--seconds`` have passed; it ends on the
   last step's read and a synchronize.  With ``--trace 1`` the profiler
   records it;
3. the peak memory read, the program's state freed, then the reference runs
   the same steps from the same parameters and batches and the check
   (``bench.check``) compares;
4. the result: the last line of standard output, one JSON object; the
   numbers compared, each with its limit, also as the last lines of
   standard error.

The window's end-to-end metrics come from ``--trace 0`` runs, the per-layer
ones from ``--trace 1`` runs.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHECK_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["Bench", "run_cell", "main"]


class Bench:
    """``BENCHMARK.json`` and the files its names lead to, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.root / c["file"]).read_text())
                if cfg["name"] != name:
                    raise ValueError(f"{c['file']} names {cfg['name']!r}")
                return cfg
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads(
            (self.root / "bench" / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads(
            (self.root / "bench" / "cells" / f"{cell}.json").read_text()
        )["limits"]

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's metrics: its end-to-end ones (``trace`` false) or its
        per-layer ones, each kept where it names no ``workloads`` or names
        this cell."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def _module(self, kind: str, name: str):
        path = self.root / "bench" / kind / f"{name}.py"
        mod_name = f"bench_{kind}_" + name.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        """``read(run) -> float | None`` of ``bench/metrics/<metric>.py``."""
        return self._module("metrics", metric).read

    def reference(self, name: str):
        return self._module("reference", name)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.splitlines()[0] if out else "not read"


def _changes(params: dict, ref_mod, cfg: dict, seed: int,
             device) -> dict[str, float]:
    """Each leaf's change from the parameters drawn from ``seed`` (drawn
    again, one stacked leaf at a time) to ``params``."""
    from bench.check import leaf_norms

    change = {}
    for path, p0 in ref_mod.make_params(cfg, seed, device):
        p = params[path]
        if path.startswith("layers/"):
            for i in range(p.shape[0]):
                change[f"{path}[{i}]"] = float(
                    (p[i].float() - p0[i].float()).norm())
        else:
            change.update(leaf_norms(path, p.float() - p0.float()))
    return change


def run_cell(bench: Bench, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_start: float | None = None) -> dict:
    """Run one cell once on ``device``; return the result's fields and the
    check's rows (``checks``).  ``device`` "cpu" is for the tests: the
    program then runs its kernels' plain versions."""
    import torch

    from bench import traffic as traffic_mod
    from bench.check import gaps, judge, leaf_norms, left_out, worst_leaves
    from bench.program import TrainProgram
    from bench.trace import Tracer, breakdown, summary

    t_start = time.perf_counter() if t_start is None else t_start
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    train = bench.traffic(cell["traffic"])
    limits = bench.limits(cell_name)
    ref_mod = bench.reference(cfg["reference"])
    on_card = device != "cpu"
    dev = torch.device(device)

    prog = TrainProgram(cfg, train)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    prog.start(dict(ref_mod.make_params(cfg, seed, dev)))
    pool = traffic_mod.batches(train, cfg["vocab_size"], seed, dev)

    # set-up: the checked steps, through the window's own call and feed
    losses, first = [], {}
    for i in range(CHECK_STEPS):
        loss, gnorm = prog.step(pool[i])
        losses.append(float(loss))
        float(gnorm)
        if i == 0:
            for path, m in prog.first_moments().items():
                first.update({k: v / (1 - train["adam_b1"]) for k, v in
                              leaf_norms(path, m).items()})
    readings = {"losses": losses, "grad": first,
                "change": _changes(prog.params(), ref_mod, cfg, seed, dev)}
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    # the window
    dispatch, steps, failed = [], 0, 0
    tracer = Tracer() if trace else contextlib.nullcontext()
    with tracer:
        t0 = time.perf_counter()
        while True:
            batch = pool[(CHECK_STEPS + steps) % len(pool)]
            t_call = time.perf_counter()
            loss, gnorm = prog.step(batch)
            dispatch.append(time.perf_counter() - t_call)
            loss, gnorm = float(loss), float(gnorm)
            steps += 1
            failed += not (math.isfinite(loss) and math.isfinite(gnorm))
            if time.perf_counter() - t0 >= seconds:
                break
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    prog.free()
    del prog, pool
    if on_card:
        torch.cuda.empty_cache()
    trace_sum = summary(tracer.events()) if trace else None

    run = {"config": cfg, "traffic": train, "setup_s": setup_s,
           "window": {"steps": steps, "seconds": window_s,
                      "tokens": steps * train["batch"] * train["seq"],
                      "dispatch_s": dispatch},
           "peak_bytes": peak, "trace": trace_sum}

    # the reference, on the same parameters and batches
    ref_pool = traffic_mod.batches(train, cfg["vocab_size"], seed, dev)
    ref = ref_mod.train_steps(
        cfg, train, seed,
        [(b["tokens"], b["labels"]) for b in ref_pool[:CHECK_STEPS]], dev)
    del ref_pool
    numbers = gaps(readings, ref)
    verdict = judge(numbers, limits)
    print(f"losses: program {readings['losses']} reference {ref['losses']}",
          file=sys.stderr)
    print(f"change_gap leaves out {left_out(ref)}", file=sys.stderr)
    for number, rows in worst_leaves(readings, ref).items():
        print(f"{number} worst leaves (leaf, gap, program, reference): "
              f"{rows}", file=sys.stderr)

    metrics = {}
    for m in bench.metrics(cell_name, trace):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": verdict["ok"] and failed == 0,
              "attempted": steps, "failed": failed, "metrics": metrics}
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": peak}
    if trace_sum is not None:
        result["device"].update(busy_s=trace_sum["busy_s"],
                                window_s=trace_sum["window_s"])
        result["breakdown"] = breakdown(trace_sum)
    result["card"] = power_limit() if on_card else "cpu"
    result["checks"] = verdict["rows"]
    return result


def jax_loaded() -> list[str]:
    """Modules whose top-level name is JAX's, its libraries' or the JAX
    package's."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def main(argv: list[str] | None = None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = Bench()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    out = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        result = run_cell(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t_start)
    loaded = jax_loaded()
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 4
    print(f"card: {result['card']}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']:.6e} limit {row['limit']:.6e}",
              file=sys.stderr)
    out.write(json.dumps(result) + "\n")
    out.flush()
    return 0
