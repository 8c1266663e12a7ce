"""Train the paper's FCNN on the synthetic dataset with Adam, every period
through the port's kernels: the PyTorch counterpart of
``examples/train_fcnn_onoc.py``, at the benchmark's full width.

  PYTHONPATH=src python -m repro_torch.launch.train_fcnn \
      [--arch NN1] [--steps 300] [--batch 64] [--device cuda] \
      [--program N [--strategy orrm] [--residency sharded]]

Single-device mode prints the ONoC plan (Lemma-1 core counts per layer),
the loss and accuracy every 50 steps (the only host syncs of the loop),
ms/step and the final train accuracy.  With ``--program N`` the plan is
compiled to a RUN/SEND/RECV/FREE period program for an N-device ring
(``repro_torch.exec``), validated and analyzed, and executed on N logical
devices of the one card: it prints the program, its cost contract
against ``simulate_epoch`` (held RUN by RUN and transition by transition),
the residency profile (per-device peak against the replicated model, and
the periods whose FREEs release chunks), the loss every 50 steps, ms/step
and the final train accuracy.  Either mode fails when a run of 300 steps
or more ends at accuracy 0.8 or below.  Without a GPU it exits with an
error unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Sequence

import torch

from repro_torch import exec as pexec
from repro_torch.configs.nn_benchmarks import NN_BENCHMARKS
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.core.planner import plan_fcnn
from repro_torch.core.simulator import simulate_epoch
from repro_torch.data import Batcher, fcnn_classification_dataset
from repro_torch.device import resolve_device
from repro_torch.exec.residency import replicated_model_bytes
from repro_torch.models import fcnn
from repro_torch.optim import Optimizer, adam, linear_warmup_cosine

__all__ = ["train", "train_step", "train_program", "cost_contract",
           "synthetic_batches", "main"]

FULL_RUN_STEPS = 300
ACCURACY_BAR = 0.8
LR = 3e-3
LOG_EVERY = 50
# the ONoC platform the plans are made for, as in the reference example
ONOC = ONoCConfig(m=1000, lambda_max=64)


def train_step(params: dict, opt: Optimizer, opt_state: dict,
               batch: dict[str, torch.Tensor], step_t: torch.Tensor,
               kernel_mode: str | None = None) -> torch.Tensor:
    """One Adam step on ``batch``, updating ``params``, ``opt_state`` and
    the fp32 step counter ``step_t`` in place.  Returns the detached loss
    without reading it, so a step never waits for the device."""
    leaves = fcnn.parameters(params)
    loss = fcnn.loss_fn(params, batch, kernel_mode=kernel_mode)
    it = iter(torch.autograd.grad(loss, leaves))
    grads = {"layers": [{"w": next(it), "b": next(it)}
                        for _ in params["layers"]]}
    opt.update(grads, opt_state, params, step_t)
    step_t += 1.0
    return loss.detach()


def train(arch: str | Sequence[int] = "NN1", steps: int = FULL_RUN_STEPS,
          batch: int = 64, device: str | torch.device | None = None,
          seed: int = 0, kernel_mode: str | None = None,
          params: dict | None = None, warmup: int = 20,
          n_samples: int = 4096, log: Callable[[str], None] = print) -> dict:
    """Run the training loop; return ``{"losses", "accuracy",
    "ms_per_step", "plan", "params", "device"}``.

    ``arch`` is a name of ``NN_BENCHMARKS`` or explicit layer sizes.
    ``params`` (the reference's numpy pytree) replaces the seeded init.
    The dataset is ``fcnn_classification_dataset(n_samples, seed=0)``,
    batched as the reference's ``Batcher`` batches it.
    """
    dev = resolve_device(device)
    sizes = _sizes(arch)
    workload = FCNNWorkload(sizes, batch_size=batch)
    plan = plan_fcnn(workload, ONOC, {"data": 1}, strategy="orrm")
    log("ONoC plan (per layer): "
        + ", ".join(f"L{p.period}: m*={p.onoc_cores} -> degree {p.degree}"
                    for p in plan.periods))

    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = fcnn.init(sizes, gen, dev)
    else:
        params = fcnn.params_from_numpy(params, dev)
    opt = adam(linear_warmup_cosine(LR, warmup, steps))
    opt_state = opt.init(params)
    batches = synthetic_batches(sizes, n_samples, batch, dev)
    x_eval, y_eval = batches.data["x"], batches.data["y"]
    step_t = torch.zeros((), dtype=torch.float32, device=dev)

    def report(i, loss):
        acc = fcnn.accuracy(params, x_eval[:1024], y_eval[:1024],
                            kernel_mode=kernel_mode)
        log(f"step {i:4d}  loss {float(loss):.4f}  acc {float(acc):.3f}")

    losses, ms = _timed_loop(
        lambda b: train_step(params, opt, opt_state, b, step_t, kernel_mode),
        batches, steps, dev, report, log)
    final_acc = float(fcnn.accuracy(params, x_eval, y_eval,
                                    kernel_mode=kernel_mode))
    log(f"final train accuracy: {final_acc:.3f}")
    return {
        "losses": torch.stack(losses).cpu().tolist() if losses else [],
        "accuracy": final_acc,
        "ms_per_step": ms,
        "plan": plan,
        "params": params,
        "device": dev,
    }


def cost_contract(program, workload: FCNNWorkload, cfg: ONoCConfig,
                  mapping, backend=None) -> str:
    """Hold a program's cost annotations to ``simulate_epoch`` on the same
    mapping: every RUN's cost to its period's compute time and every
    SEND's to its transition's time.  The totals are not compared: the
    program sums with builtin ``sum()`` and the simulator with ``+=``, so
    they may differ in the last bit (``exec/program.py``).  Returns the
    line to print; raises ``RuntimeError`` on a mismatch."""
    trace = simulate_epoch(workload, cfg, mapping=mapping, backend=backend)
    runs = [r.cost_s for r in program.runs()]
    sends = [(s.period, s.cost_s) for s in program.sends()]
    if runs != list(trace.per_period_compute_s):
        raise RuntimeError(f"RUN costs {runs} != simulate_epoch's "
                           f"{list(trace.per_period_compute_s)}")
    if sends != [(t.period, t.comm_s) for t in trace.transitions]:
        raise RuntimeError(f"SEND costs {sends} != simulate_epoch's "
                           f"transitions {trace.transitions}")
    return (f"cost contract: {len(runs)} RUN and {len(sends)} SEND costs "
            f"equal simulate_epoch's; program total {program.total_s:.6e} s,"
            f" simulate_epoch {trace.total_s:.6e} s")


def train_program(arch: str | Sequence[int] = "NN1", n_devices: int = 8,
                  strategy: str = "orrm", residency: str = "sharded",
                  steps: int = FULL_RUN_STEPS, batch: int = 64,
                  device: str | torch.device | None = None, seed: int = 0,
                  kernel_mode: str | None = None, params: dict | None = None,
                  warmup: int = 20, n_samples: int = 4096,
                  log: Callable[[str], None] = print) -> dict:
    """``train`` through the compiled period program on ``n_devices``
    logical devices (``repro_torch.exec.compile``, analyzed at "full");
    return ``{"losses", "accuracy", "ms_per_step", "executable",
    "state", "device"}``.  Same data, schedule and optimizer as
    ``train``; the final accuracy is taken on the gathered parameters
    through the single-device path."""
    dev = resolve_device(device)
    sizes = _sizes(arch)
    workload = FCNNWorkload(sizes, batch_size=batch)
    exe = pexec.compile(workload, ONOC, n_devices, strategy=strategy,
                        residency=residency, kernel_mode=kernel_mode,
                        device=dev)
    prog = exe.program
    log(f"compiled {prog.strategy.upper()} program (schema v{prog.version}, "
        f"{residency} residency): {len(prog.instructions)} instructions "
        f"over {2 * prog.l} periods on a {n_devices}-device ring, degrees "
        f"{list(prog.degrees)}")
    for i in prog.instructions:
        extra = ""
        if i.opcode is pexec.Opcode.RUN:
            extra = (f" layer={i.layer} {i.phase} m*={i.onoc_cores} "
                     f"degree={i.degree}")
        elif i.opcode is pexec.Opcode.FREE and i.layer is not None:
            extra = f" layer={i.layer} param_bytes={i.param_bytes:.0f}"
        log(f"  P{i.period:>2} {i.opcode.value.upper():<4} "
            f"devices={list(i.devices)} cost={i.cost_s:.3e}s{extra}")
    log(cost_contract(prog, workload, ONOC, exe.plan.mapping))
    tr = exe.tracker
    log(f"residency ({residency}): peak {max(tr.peak_bytes()):.0f} B/device "
        f"vs {replicated_model_bytes(prog):.0f} B replicated (ratio "
        f"{tr.peak_ratio():.3f}); FREEs release at periods "
        f"{tr.release_periods()}")

    opt = adam(linear_warmup_cosine(LR, warmup, steps))
    state = exe.init_state(torch.Generator().manual_seed(seed), opt,
                           params=params)
    step = exe.train_step(opt)
    batches = synthetic_batches(sizes, n_samples, batch, dev)

    def report(i, loss):
        log(f"step {i:4d}  loss {float(loss):.4f}")

    losses, ms = _timed_loop(lambda b: step(state, b)[1]["loss"], batches,
                             steps, dev, report, log)
    full = state["params"]
    if residency == "sharded":
        full = exe.gather_params(full)
    final_acc = float(fcnn.accuracy(full, batches.data["x"],
                                    batches.data["y"],
                                    kernel_mode=kernel_mode))
    log(f"final train accuracy: {final_acc:.3f}")
    return {
        "losses": torch.stack(losses).cpu().tolist() if losses else [],
        "accuracy": final_acc,
        "ms_per_step": ms,
        "executable": exe,
        "state": state,
        "device": dev,
    }


def _sizes(arch: str | Sequence[int]) -> list[int]:
    return list(NN_BENCHMARKS[arch] if isinstance(arch, str) else arch)


def synthetic_batches(sizes: Sequence[int], n_samples: int, batch: int,
                      dev: torch.device) -> Batcher:
    """The dataset ``fcnn_classification_dataset(n_samples, seed=0)`` on
    ``dev``, batched as the reference's ``Batcher`` batches it."""
    x, y = fcnn_classification_dataset(n_samples, input_dim=sizes[0], seed=0)
    return Batcher({"x": x, "y": y}, batch_size=batch, device=dev)


def _timed_loop(step: Callable[[dict], torch.Tensor], batches: Batcher,
                steps: int, dev: torch.device,
                report: Callable[[int, torch.Tensor], None],
                log: Callable[[str], None]) -> tuple[list, float]:
    """Run ``step`` (batch -> detached loss) ``steps`` times, calling
    ``report`` every LOG_EVERY steps and at the last; return the losses
    (device tensors) and ms/step on the host clock."""
    losses = []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        losses.append(step(next(batches)))
        if i % LOG_EVERY == 0 or i == steps - 1:
            report(i, losses[-1])
    _sync(dev)
    dt = time.perf_counter() - t0
    ms = 1e3 * dt / max(steps, 1)
    log(f"{steps} steps in {dt:.3f}s ({ms:.3f} ms/step) on {_name(dev)}")
    return losses, ms


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="NN1", choices=sorted(NN_BENCHMARKS))
    ap.add_argument("--steps", type=int, default=FULL_RUN_STEPS)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda, and fail if there is none")
    ap.add_argument("--program", type=int, default=0, metavar="N",
                    help="compile the plan to a period program and execute "
                         "it on an N-device ring of logical devices")
    ap.add_argument("--strategy", default="orrm",
                    choices=["fm", "rrm", "orrm"],
                    help="core mapping strategy (program mode)")
    ap.add_argument("--residency", default="sharded",
                    choices=["sharded", "replicated"],
                    help="program-mode params layout: per-device column "
                         "chunks or the full model on every device")
    args = ap.parse_args(argv)
    if args.program:
        out = train_program(arch=args.arch, n_devices=args.program,
                            strategy=args.strategy, residency=args.residency,
                            steps=args.steps, batch=args.batch,
                            device=args.device)
    else:
        out = train(arch=args.arch, steps=args.steps, batch=args.batch,
                    device=args.device)
    if args.steps >= FULL_RUN_STEPS and out["accuracy"] <= ACCURACY_BAR:
        print(f"training failed to learn: accuracy {out['accuracy']:.3f} "
              f"<= {ACCURACY_BAR}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
