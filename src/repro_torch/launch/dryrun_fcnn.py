"""Dry-run of the paper's own workload on the meta device: one training
step of each FCNN (NN1–NN6) in the port's parallel form, the port's
counterpart of the reference ``repro/launch/dryrun_fcnn.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_fcnn [--batch 128] \
      [--devices 8] [--multipod] [--kernel cuda|ref] \
      [--out results/dryrun_fcnn_torch.json]

Each cell reports the reference's per-layer plan, ``plan_fcnn`` on the
production mesh's shape (``{"data": 16, "model": 16}``, or with
``"pod": 2`` under ``--multipod``) as a dict: its sharding ``degrees``
and the Lemma-1 ``onoc_cores`` m*.  Then it lowers what the port runs:
the NN's ORRM period program on ``--devices`` logical devices in sharded
residency (``repro_torch.exec.compile``), one Adam step on meta tensors
under ``launch.dryrun.count``: the kernels' launches, operations and
bytes, the peak, ``temp_gb`` (peak less the state and batch the step
takes), per logical device the flops of the chunks it runs (K1 forward,
K2 and K3 backward, from ``kernels.cost``; the loss period's K4/K5 apart)
and ``collective_bytes``, the activation bytes the step's SENDs carry:
each forward SEND the window's (B, n_i / d_i) output chunks, each
backward SEND the window's (B, n_{i-1}) partial input gradients.
``--kernel`` is the executor's ``kernel_mode``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Sequence

import torch

from repro_torch import exec as pexec
from repro_torch.configs.nn_benchmarks import (
    NN_BENCHMARKS,
    onoc_config,
    workload,
)
from repro_torch.core.planner import H100Target, plan_fcnn
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import ops
from repro_torch.launch.dryrun import META, count
from repro_torch.optim import adam

__all__ = ["PRODUCTION_MESH", "chunk_flops", "send_bytes", "lower_nn",
           "run_nn", "main"]

PRODUCTION_MESH = {"data": 16, "model": 16}
MULTIPOD_MESH = {"pod": 2, "data": 16, "model": 16}
DEFAULT_OUT = "results/dryrun_fcnn_torch.json"
BYTES_F32 = 4


def chunk_flops(program, batch: int) -> list[float]:
    """Flops each logical device's chunk kernels do in one step: K1 for
    every forward period whose window holds it, K3 and (past layer 1) K2
    for the backward."""
    sizes = program.layer_sizes
    out = [0.0] * program.n_devices
    for run in program.runs("fp"):
        k, w = sizes[run.layer - 1], run.chunk_width
        work = [kcost.fcnn_fwd(batch, k, w), kcost.fcnn_wgrad(batch, k, w)]
        if run.layer > 1:
            work.append(kcost.fcnn_dgrad(batch, k, w))
        per_chunk = sum(c.flops["float32"] for c in work)
        for dev in run.devices:
            out[dev] += per_chunk
    return out


def send_bytes(program, batch: int) -> float:
    """Activation bytes the step's SENDs carry (module docstring)."""
    runs = {r.period: r for r in program.runs()}
    total = 0.0
    for send in program.sends():
        run = runs[send.period]
        width = (run.chunk_width if run.phase == "fp"
                 else program.layer_sizes[run.layer - 1])
        total += len(send.devices) * batch * width * BYTES_F32
    return total


def lower_nn(name: str, batch: int, n_devices: int,
             kernel_mode: str | None = None, lambda_max: int = 64):
    """(executable, counter) of one sharded ORRM step of ``name`` on the
    meta device."""
    exe = pexec.compile(workload(name, batch), onoc_config(lambda_max),
                        n_devices, strategy="orrm", residency="sharded",
                        kernel_mode=kernel_mode, device=META)
    opt = adam(1e-3)
    sizes = NN_BENCHMARKS[name]
    step = exe.train_step(opt)

    def setup():
        return (exe.init_state(torch.Generator(), opt),
                {"x": torch.empty((batch, sizes[0]), device=META),
                 "y": torch.empty((batch,), dtype=torch.int32, device=META)})

    return exe, count(setup, lambda args: step(*args))


def run_nn(name: str, batch: int = 128, n_devices: int = 8,
           multi_pod: bool = False, kernel_mode: str | None = None,
           target: H100Target = H100Target()) -> dict:
    t0 = time.perf_counter()
    mesh = MULTIPOD_MESH if multi_pod else PRODUCTION_MESH
    plan = plan_fcnn(workload(name, batch), onoc_config(64), dict(mesh),
                     strategy="orrm")
    exe, c = lower_nn(name, batch, n_devices, kernel_mode)
    flops = c.total_flops()
    compute_s, memory_s = kcost.Cost(flops, c.total_bytes()).seconds(target)
    return {
        "ok": True,
        "degrees": plan.degrees,
        "onoc_cores": [p.onoc_cores for p in plan.periods],
        "devices": n_devices,
        "program_degrees": list(exe.program.degrees),
        "flops_per_device": chunk_flops(exe.program, batch),
        "flops": sum(flops.values()),
        "bytes": c.total_bytes(),
        "collective_bytes": send_bytes(exe.program, batch),
        "compute_s": compute_s,
        "memory_s": memory_s,
        "bottleneck": "compute" if compute_s >= memory_s else "memory",
        "kernel_launches": {k: c.launches[k] for k in ops.KERNELS},
        "peak_memory_per_device": float(c.peak),
        "step_peak_bytes": float(c.step_peak),
        "state_bytes": float(c.state_bytes),
        "temp_gb": (c.peak - c.state_bytes) / 1e9,
        "seconds": round(time.perf_counter() - t0, 3),
    }


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--kernel", default=None, choices=["cuda", "ref"],
                    help="the executor's kernel_mode")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    mesh_name = "2x16x16" if args.multipod else "16x16"
    for name in sorted(NN_BENCHMARKS):
        key = (f"{name}|train_b{args.batch}|{mesh_name}|"
               f"ring{args.devices}")
        print(f"[run] {key}", flush=True)
        try:
            res = run_nn(name, args.batch, args.devices, args.multipod,
                         args.kernel)
            print(f"  ok: degrees={res['degrees']} (ONoC "
                  f"m*={res['onoc_cores']}); ring {args.devices}: degrees "
                  f"{res['program_degrees']}, launches "
                  f"{ {k: v for k, v in res['kernel_launches'].items() if v} }"
                  f", peak "
                  f"{res['peak_memory_per_device'] / 2**20:.2f} MiB, temp "
                  f"{res['temp_gb']:.4f} GB, SEND "
                  f"{res['collective_bytes'] / 1e6:.3f} MB "
                  f"[{res['seconds']}s]", flush=True)
        except Exception as e:  # noqa: BLE001 — recorded, the sweep goes on
            res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            print(f"  FAIL: {type(e).__name__}: {e}")
        results[key] = res
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"{n_ok}/{len(results)} FCNN cells ok -> {args.out}")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
