"""Fault-tolerance scenarios on the port: crash and restart, elastic
replanning, and the seeded device-loss -> replan -> checkpoint-resume
loop, the counterpart of the reference's ``examples/elastic_restart.py``.

  PYTHONPATH=src python -m repro_torch.launch.elastic_restart \
      [--device cpu] [--sizes 32 16 8 10]

  1. ``crash_restart``: a step fails once; ``TrainingSupervisor`` restarts
     from the latest checkpoint (params, Adam moments and the Batcher's
     position) and training finishes.
  2. ``elastic_shrink``: ``ElasticPlanner.plan_for`` at m = 1000, 500, 100.
  3. ``device_loss_replan_resume``: ``DegradedModeRunner`` trains through
     the compiled ORRM period program on a ring of 8 logical devices
     under a ``FaultSchedule``: ``seeded_device_loss`` (seed 0) of 2
     devices, and a transient RUN fault at step 10 that fails twice.
     The loss of devices triggers the Lemma-1 replan on the survivors,
     a re-validated and analyzed
     program, a new executor and the resume from the latest checkpoint.
     The run is held to a from-scratch run on the survivors from the same
     weights, at the reference's bars (per-step losses rtol 1e-4 / atol
     1e-6, final params rtol 1e-3 / atol 5e-4).  It prints the schedule,
     the replan, the survivor program's degrees, ms/step and the kernel
     launches per step on each ring (host clock at each batch drawn), the
     seconds from the fault to the first resumed step, the size of one
     checkpoint and the time of one save, and the final train accuracy.

Scenario 3 trains at batch 64, sharded, with an async checkpoint every
50 steps, on ``launch.train_fcnn``'s data, seed and learning-rate
schedule, for 300 steps: by default NN1 (784-1000-500-10) at full
width, failing at accuracy 0.8 or below; ``--sizes`` takes other layer
sizes (the reference example's, 32 16 8 10, for a quick run on the host),
held to no accuracy bar.  The command fails if the runner fell back to
the plain versions of the kernels.  Everything runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.configs.nn_benchmarks import NN_BENCHMARKS
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.data import Batcher, fcnn_classification_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.train_fcnn import (
    ACCURACY_BAR,
    FULL_RUN_STEPS,
    LR,
    ONOC,
    synthetic_batches,
    train_step,
)
from repro_torch.models import fcnn
from repro_torch.optim import adam, linear_warmup_cosine
from repro_torch.runtime import (
    DegradedModeRunner,
    ElasticPlanner,
    FaultEvent,
    FaultKind,
    FaultSchedule,
    TrainingSupervisor,
)

__all__ = ["Scenario", "NN1_SCENARIO", "StepClock", "per_step",
           "recovery_seconds", "crash_restart", "elastic_shrink",
           "fault_schedule", "recovery_run", "device_loss_replan_resume",
           "main"]

# the kernels of the FCNN path, K1-K5
FCNN_KERNELS = ("fcnn_layer", "fcnn_layer_dgrad", "fcnn_layer_wgrad",
                "softmax_xent_fwd", "softmax_xent_dlogits")
# the reference's bars for a resumed run against a from-scratch run on the
# survivors (tests/test_fault_recovery.py)
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-3, 5e-4


# scenario 3's fixed settings: batch, ring, devices lost, the step of
# the transient RUN fault, and the warmup of the learning-rate schedule
BATCH, N_DEVICES, N_LOST, TRANSIENT_STEP, WARMUP = 64, 8, 2, 10, 20


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Scenario 3's model, length and checkpoint interval."""

    sizes: tuple[int, ...] = tuple(NN_BENCHMARKS["NN1"])
    n_steps: int = FULL_RUN_STEPS
    checkpoint_every: int = 50


NN1_SCENARIO = Scenario()


class StepClock:
    """The batches, marked at each draw with the batch index, the host
    clock and the kernel launch counts.  A training step draws once, so
    consecutive marks bound one step; a restore moves the index back."""

    def __init__(self, batches: Batcher):
        self.batches = batches
        self.marks: list[tuple[int, float, dict[str, int]]] = []

    def __iter__(self):
        return self

    def __next__(self):
        counts = ops.launch_counts()
        self.marks.append((self.batches.step, time.perf_counter(),
                           {k: counts[k] for k in FCNN_KERNELS}))
        return next(self.batches)

    def state(self) -> dict:
        return self.batches.state()

    def restore(self, state: dict) -> None:
        self.batches.restore(state)

    def segments(self) -> list[list[tuple]]:
        """The marks split where the index does not move on by one."""
        out: list[list[tuple]] = []
        for m in self.marks:
            if out and m[0] == out[-1][-1][0] + 1:
                out[-1].append(m)
            else:
                out.append([m])
        return out


def per_step(seg: list[tuple]) -> tuple[float, dict[str, float]]:
    """(ms, launches by kernel) per step over a segment's marks."""
    steps = len(seg) - 1
    if steps < 1:
        return float("nan"), {}
    ms = 1e3 * (seg[-1][1] - seg[0][1]) / steps
    return ms, {k: (seg[-1][2][k] - seg[0][2][k]) / steps
                for k in seg[0][2]}


def recovery_seconds(clock: StepClock) -> list[float]:
    """Host seconds from the draw of each step that lost a device to the
    draw of the first resumed step (replan, validate and analyze, rebuild,
    restore): one per replan."""
    segs = clock.segments()
    return [b[0][1] - a[-1][1] for a, b in zip(segs, segs[1:])]


def crash_restart(device: str | torch.device | None = None,
                  log: Callable[[str], None] = print) -> list[dict]:
    """Scenario 1: transient crash mid-run; restart from checkpoint."""
    dev = resolve_device(device)
    sizes = [64, 128, 64, 10]
    opt = adam(3e-3)
    params = fcnn.init(sizes, torch.Generator().manual_seed(0), dev)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.float32, device=dev)}
    x, y = fcnn_classification_dataset(1024, input_dim=64, seed=1)
    batches = Batcher({"x": x, "y": y}, batch_size=32, device=dev)
    calls = 0

    def step_fn(state, batch):
        nonlocal calls
        calls += 1
        if calls == 60:                              # injected crash
            raise RuntimeError("simulated node failure")
        loss = train_step(state["params"], opt, state["opt"], batch,
                          state["step"])
        return state, {"loss": loss}

    with tempfile.TemporaryDirectory(prefix="repro_torch_elastic_") as tmp:
        sup = TrainingSupervisor(Checkpointer(tmp), checkpoint_every=20,
                                 max_retries=0, backoff_s=0.0)
        state, history = sup.run(state, step_fn, batches, 100)
    first, last = float(history[0]["loss"]), float(history[-1]["loss"])
    log(f"completed {len(history)} steps with 1 injected failure; loss "
        f"{first:.3f} -> {last:.3f}")
    if not last < first:
        raise RuntimeError("the restarted run did not learn")
    return history


def elastic_shrink(log: Callable[[str], None] = print) -> list:
    """Scenario 2: the paper's model as the re-planning oracle."""
    planner = ElasticPlanner(FCNNWorkload([64, 128, 64, 10], batch_size=32),
                             ONoCConfig(m=1000, lambda_max=64))
    plans = []
    for m in (1000, 500, 100):
        _, cores, mapping = planner.plan_for(m)
        plans.append(cores)
        log(f"cluster size {m:4d}: allocation {cores} "
            f"({mapping.strategy.value} placement, "
            f"{len(mapping.active_cores())} active)")
    return plans


def fault_schedule(sc: Scenario) -> FaultSchedule:
    """``seeded_device_loss`` (seed 0) of N_LOST devices over the run,
    and a transient RUN fault at TRANSIENT_STEP (period 1, device 0)
    that fails two attempts."""
    loss = FaultSchedule.seeded_device_loss(
        0, n_steps=sc.n_steps, n_devices=N_DEVICES,
        n_periods=2 * (len(sc.sizes) - 1), n_lost=N_LOST)
    transient = FaultEvent(kind=FaultKind.TRANSIENT_RUN, step=TRANSIENT_STEP,
                           period=1, device=0, count=2)
    return FaultSchedule(events=loss.events + (transient,), seed=loss.seed)


def recovery_run(sc: Scenario, schedule: FaultSchedule, n_devices: int,
                 residency: str = "sharded",
                 device: str | torch.device | None = None,
                 seed: int = 0) -> dict[str, Any]:
    """Train ``sc`` through ``DegradedModeRunner`` on ``n_devices`` under
    ``schedule``, from ``fcnn.init`` with ``seed``.  Returns the runner,
    the final state, the report, the ``StepClock``, the final train
    accuracy and, from one more save of the final state, the checkpoint's
    bytes on disk and the seconds of its snapshot (the part of an async
    save a step waits for) and of its write."""
    dev = resolve_device(device)
    sizes = list(sc.sizes)
    params0 = fcnn.init(sizes, torch.Generator().manual_seed(seed), dev)
    opt = adam(linear_warmup_cosine(LR, WARMUP, sc.n_steps))
    clock = StepClock(synthetic_batches(sizes, 4096, BATCH, dev))
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as tmp:
        ck = Checkpointer(tmp)
        runner = DegradedModeRunner(
            workload=FCNNWorkload(sizes, batch_size=BATCH), base_cfg=ONOC,
            schedule=schedule, checkpointer=ck, optimizer=opt,
            n_devices=n_devices, residency=residency,
            checkpoint_every=sc.checkpoint_every, backoff_s=0.0, device=dev)
        state, _, report = runner.run(params0, opt.init(params0), clock,
                                      sc.n_steps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)   # time the save, not the queue
        t0 = time.perf_counter()
        ck.save(sc.n_steps, state, blocking=False)
        t1 = time.perf_counter()
        ck.wait()
        t2 = time.perf_counter()
        d = os.path.join(tmp, f"step_{latest_step(tmp)}")
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d))
    data = clock.batches.data
    acc = float(fcnn.accuracy(state["params"], data["x"], data["y"]))
    return {"runner": runner, "state": state, "report": report,
            "clock": clock, "accuracy": acc,
            "checkpoint_bytes": nbytes, "snapshot_s": t1 - t0,
            "write_s": t2 - t1}


def _excess(a: torch.Tensor, b: torch.Tensor, rtol: float,
            atol: float) -> float:
    """max |a - b| / (atol + rtol·|b|): at most 1 where ``a`` is within
    the bars of ``b``, as ``numpy.testing.assert_allclose`` checks."""
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def device_loss_replan_resume(sc: Scenario = NN1_SCENARIO,
                              device: str | torch.device | None = None,
                              seed: int = 0,
                              log: Callable[[str], None] = print
                              ) -> dict[str, Any]:
    """Scenario 3, sharded: the run under ``fault_schedule(sc)`` and a
    from-scratch run on the survivors; raises ``RuntimeError`` unless the
    two agree at the reference's bars.  Returns ``{"schedule",
    "faulted", "scratch", "segments", "recovery_s", "loss_excess",
    "param_excess"}``, the two runs as ``recovery_run`` returns them, and
    per ring (segment of the faulted run) its device count, program
    degrees, ms/step and launches per step."""
    dev = resolve_device(device)
    schedule = fault_schedule(sc)
    log(f"fault schedule: {schedule.to_dicts()}")
    faulted = recovery_run(sc, schedule, N_DEVICES, "sharded", dev, seed)
    report = faulted["report"]
    survivors = N_DEVICES - N_LOST
    scratch = recovery_run(sc, FaultSchedule(), survivors, "sharded", dev,
                           seed)

    planner = faulted["runner"].planner
    rings = [N_DEVICES] + [r["to_devices"] for r in report.replans]
    segs = faulted["clock"].segments()
    if len(segs) != len(rings):
        raise RuntimeError(f"{len(segs)} runs of steps for rings {rings}")
    segments, recovery_s = [], recovery_seconds(faulted["clock"])
    for n, seg in zip(rings, segs):
        ms, launches = per_step(seg)
        degrees = planner.replan_program(n)[2].degrees
        segments.append({"devices": n, "degrees": degrees,
                         "steps": (seg[0][0], seg[-1][0]), "ms": ms,
                         "launches": launches})
        log(f"ring of {n} devices, degrees {list(degrees)}: steps "
            f"{seg[0][0]}-{seg[-1][0]}, {ms:.4f} ms/step (host clock), "
            f"launches per step "
            + ", ".join(f"{k} {v:g}" for k, v in launches.items()))
    for rp, s in zip(report.replans, recovery_s):
        log(f"device loss at step {rp['step']} period {rp['period']}: lost "
            f"{rp['lost']}, replanned {rp['from_devices']} -> "
            f"{rp['to_devices']} devices, resumed from checkpoint "
            f"{rp['resume_checkpoint']}; {s:.4f} s from the fault to the "
            f"first resumed step")
    log(f"report: retries {report.retries}, kernel fallbacks "
        f"{report.kernel_fallbacks}, straggles {report.straggles}, "
        f"resumed from {report.resumed_from}")
    log(f"checkpoint: {faulted['checkpoint_bytes']} bytes, snapshot "
        f"{1e3 * faulted['snapshot_s']:.3f} ms, write "
        f"{1e3 * faulted['write_s']:.3f} ms")

    got, want = faulted["runner"].losses, scratch["runner"].losses
    if sorted(got) != list(range(sc.n_steps)):
        raise RuntimeError(f"steps run: {sorted(got)}")
    loss_excess = _excess(torch.tensor([got[s] for s in range(sc.n_steps)]),
                          torch.tensor([want[s] for s in range(sc.n_steps)]),
                          LOSS_RTOL, LOSS_ATOL)
    param_excess = max(
        _excess(a.detach(), b.detach(), PARAM_RTOL, PARAM_ATOL)
        for a, b in zip(fcnn.parameters(faulted["state"]["params"]),
                        fcnn.parameters(scratch["state"]["params"])))
    log(f"against a from-scratch run on {survivors} devices: losses' worst "
        f"|diff| / ({LOSS_ATOL:g} + {LOSS_RTOL:g}·|scratch|) "
        f"{loss_excess:.4f}, params' ({PARAM_ATOL:g} + {PARAM_RTOL:g}·"
        f"|scratch|) {param_excess:.4f} (<= 1)")
    log(f"final train accuracy {faulted['accuracy']:.4f} (from scratch on "
        f"{survivors} devices {scratch['accuracy']:.4f})")
    if loss_excess > 1 or param_excess > 1:
        raise RuntimeError("the resumed run does not match the from-scratch "
                           "run on the survivors")
    return {"schedule": schedule, "faulted": faulted, "scratch": scratch,
            "segments": segments, "recovery_s": recovery_s,
            "loss_excess": loss_excess, "param_excess": param_excess}


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda, and fail if there is none")
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=list(NN1_SCENARIO.sizes),
                    help="scenario 3's layer sizes (default: NN1)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sc = Scenario(sizes=tuple(args.sizes))
    print("== scenario 1: crash and restart")
    crash_restart(dev)
    print("== scenario 2: elastic replanning")
    elastic_shrink()
    print(f"== scenario 3: device loss -> replan -> resume, layers "
          f"{list(sc.sizes)}, batch {BATCH}, {sc.n_steps} steps")
    out = device_loss_replan_resume(sc, dev)
    fallbacks = out["faulted"]["report"].kernel_fallbacks
    if fallbacks:
        print(f"the runner fell back to the plain versions {fallbacks} "
              f"times", file=sys.stderr)
        return 1
    acc = out["faulted"]["accuracy"]
    if sc == NN1_SCENARIO and acc <= ACCURACY_BAR:
        print(f"training failed to learn: accuracy {acc:.3f} <= "
              f"{ACCURACY_BAR}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
