"""Degraded-mode training: fault injection -> replan -> checkpoint-resume,
the port's counterpart of the reference's ``repro/runtime/degraded.py``.

``DegradedModeRunner`` closes the loop:

  1. every training step walks the compiled ``PeriodProgram``'s
     instruction list and lets the ``FaultInjector`` fire scheduled faults
     at instruction boundaries;
  2. transient RUN faults propagate to ``TrainingSupervisor``'s bounded
     retry-with-backoff loop (and, past ``max_retries``, its
     restart-from-checkpoint fallback);
  3. on the CPU, a kernel failure switches the executor to the plain
     versions (``ProgramExecutor.degrade("ref")``) and retries the step:
     the one change of kernel mode the port allows, made here and never
     inside ``kernels/ops``, logged as a warning and counted in
     ``FaultReport.kernel_fallbacks``.  On the card every failure that is
     not a scheduled fault is re-raised: a run there never falls back to
     the plain versions;
  4. a ``DeviceLossFault`` ends the current ring: the runner asks
     ``ElasticPlanner.replan_program`` for the Lemma-1 plan on the
     survivors, validates (and analyzes) the recompiled program, binds a
     new ``Executable`` to it, and re-enters the supervisor, which
     restores the latest complete checkpoint (with the ``Batcher``'s
     position, so no sample is skipped or repeated) and resumes.  With no
     checkpoint yet, it restarts from the initial state and data position.

The state is ``{"params", "opt_state", "step"}`` in the full layout, as
the reference keeps it, so a checkpoint restores on a ring of any size
and under the reference's keys.  In sharded residency the params are
sliced into the survivor ring's stacked layout inside the differentiated
step (``ProgramExecutor.slice_params``, whose backward is the gather) and
Adam runs on the full-layout gradients: sharded and replicated recovery
are bit-identical.  The executor's numerics do not depend on the ring
size beyond the order of fp32 sums, so the resumed trajectory matches a
from-scratch run on the survivors to fp tolerance.

Where PyTorch forces a difference from the reference:
  * the optimizer and the step update the state in place, so ``run``
    trains copies of the caller's ``params`` and ``opt_state`` on the
    runner's device, and keeps an untouched copy of the initial state for
    the restart when a device is lost before the first checkpoint;
  * the step counter is an fp32 tensor on the device (the optimizer reads
    it there); the runner keeps the step number on the host and reads the
    state's only when the supervisor hands it a state the runner did not
    produce (the first one, or one restored from a checkpoint);
  * losses stay on the device: ``losses`` reads them all at once when it
    is read, and the supervisor's history holds 0-d tensors.  A step thus
    never waits for the device, and the times the supervisor and the
    injector take are host times;
  * there is no mesh: ``device`` (the card unless the caller asks for the
    CPU) takes the place of ``mesh_factory``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.allocation import MappingStrategy
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.device import resolve_device
from repro_torch.exec.api import Executable
from repro_torch.exec.runtime import ProgramExecutor
from repro_torch.exec.validate import validate_program
from repro_torch.models import fcnn
from repro_torch.optim.optimizers import Optimizer, _map_tree
from repro_torch.runtime.elastic import ElasticPlanner
from repro_torch.runtime.fault_tolerance import TrainingSupervisor
from repro_torch.runtime.faults import (
    DeviceLossFault,
    FaultError,
    FaultInjector,
    FaultReport,
    FaultSchedule,
)

__all__ = ["DegradedModeRunner"]

log = logging.getLogger(__name__)


def _copy(tree: Any, device: torch.device, grad: bool | None = None) -> Any:
    """A copy of a tree of tensors on ``device``, whose leaves require
    grad if ``grad`` says so (by default, as the source's do)."""
    def leaf(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to(device, copy=True).requires_grad_(
            t.requires_grad if grad is None else grad)

    return _map_tree(leaf, tree)


@dataclasses.dataclass
class DegradedModeRunner:
    """Drives training through TrainingSupervisor under a FaultSchedule,
    replanning + recompiling + resuming-from-checkpoint on device loss.

    ``workload.m``-independent: the paper config's ``m`` is re-derived from
    the live device count at every (re)plan, so Lemma 1 always answers for
    the ring that actually exists.

    ``residency`` selects the executor path: ``"sharded"`` runs the
    weight-sharded executor (params sliced at step start into per-device
    chunks of the current ring), ``"replicated"`` the full model on every
    device.  The canonical state is in the full layout either way, and
    both paths give bit-identical losses and params.
    """

    workload: FCNNWorkload
    base_cfg: ONoCConfig
    schedule: FaultSchedule
    checkpointer: Checkpointer
    optimizer: Optimizer
    n_devices: int
    strategy: MappingStrategy = MappingStrategy.ORRM
    kernel_mode: str | None = None
    residency: str = "replicated"
    backend: Any = None
    analyze: str = "full"               # exec.analysis level per rebuild
    checkpoint_every: int = 2
    max_retries: int = 3
    backoff_s: float = 0.01
    device: str | torch.device | None = None
    report: FaultReport = dataclasses.field(default_factory=FaultReport)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self.injector = FaultInjector(self.schedule, report=self.report)
        self.planner = ElasticPlanner(self.workload, self.base_cfg,
                                      strategy=self.strategy)
        self.program = None
        self.executable: Executable | None = None
        self.executor: ProgramExecutor | None = None
        self._losses: dict[int, torch.Tensor] = {}
        self._live: dict | None = None   # the state the last step returned
        self._step = 0                   # its step number, on the host

    @property
    def losses(self) -> dict[int, float]:
        """step -> last observed loss (one read from the device)."""
        steps = sorted(self._losses)
        if not steps:
            return {}
        values = torch.stack([self._losses[s] for s in steps]).tolist()
        return dict(zip(steps, values))

    # ---------------------------------------------------------------- build

    def _build(self, n_devices: int) -> None:
        """(Re)plan, recompile, re-validate and rebind the executor for
        ``n_devices`` survivors."""
        cfg, plan, program = self.planner.replan_program(
            n_devices, backend=self.backend)
        # compile_program already validated; re-assert explicitly so the
        # replan path cannot lose the check if compile defaults change,
        # and re-run the per-device static analyzer — a replanned program
        # for a shrunken ring is exactly where a schedule bug would
        # surface first (exec/analysis; ``analyze="off"`` skips it).
        validate_program(program, self.workload, cfg, backend=self.backend,
                         analyze=None if self.analyze == "off"
                         else self.analyze)
        self.program = program
        self.executable = Executable.from_program(
            program, residency=self.residency, kernel_mode=self.kernel_mode,
            device=self.device, workload=self.workload, cfg=cfg, plan=plan,
            backend=self.backend)
        self.executor = self.executable.executor

    # ----------------------------------------------------------------- step

    def _train(self, state: dict, batch: dict) -> torch.Tensor:
        """One optimizer step on ``state``, in place; the detached loss."""
        ex = self.executor
        params = state["params"]
        leaves = fcnn.parameters(params)
        run_params = (ex.slice_params(params) if ex.residency == "sharded"
                      else params)
        loss = ex.loss_fn(run_params, batch)
        it = iter(torch.autograd.grad(loss, leaves))
        grads = {"layers": [{"w": next(it), "b": next(it)}
                            for _ in params["layers"]]}
        self.optimizer.update(grads, state["opt_state"], params,
                              state["step"])
        state["step"] += 1
        return loss.detach()

    def _step_fn(self, state: dict, batch: dict) -> tuple[dict, dict]:
        if state is not self._live:
            self._live, self._step = state, int(state["step"])
        step = self._step
        for instr in self.program.instructions:
            self.injector.instruction_boundary(step, instr)
        t0 = time.monotonic()
        try:
            loss = self._train(state, batch)
        except FaultError:
            raise
        except Exception as e:
            self._fall_back(step, e)
            loss = self._train(state, batch)
        self.injector.observe_step(step, time.monotonic() - t0)
        self._losses[step] = loss
        self._step += 1
        return state, {"loss": loss}

    def _fall_back(self, step: int, e: Exception) -> None:
        """After the kernel path failed with ``e`` at ``step``: on the CPU,
        switch the executor to the plain versions, once.  On the card, or
        where the executor already runs the plain versions (a failure of
        the plain path is a real bug), re-raise ``e``."""
        if self.device.type != "cpu" or self.executor.kernel_mode == "ref":
            raise e
        log.warning("step %d: kernel path failed (%s: %s); the executor "
                    "degrades to kernel_mode='ref'", step, type(e).__name__, e)
        self.executor.degrade("ref")
        self.report.kernel_fallbacks += 1

    # ------------------------------------------------------------------ run

    def run(self, params: Any, opt_state: Any, batches: Any,
            n_steps: int) -> tuple[dict, list[dict], FaultReport]:
        """Train ``n_steps`` under the fault schedule.  Returns the final
        state dict ``{"params", "opt_state", "step"}``, the supervisor's
        metric history, and the structured FaultReport.  ``params`` and
        ``opt_state`` are copied, never updated."""
        n = self.n_devices
        # the initial state, never trained on: the steps update ``state``
        # in place, and a restart with no checkpoint copies this again
        state0 = {"params": _copy(params, self.device, grad=True),
                  "opt_state": _copy(opt_state, self.device, grad=False),
                  "step": torch.zeros((), dtype=torch.float32,
                                      device=self.device)}
        data_state0 = batches.state() if hasattr(batches, "state") else None
        history: list[dict] = []
        state = _copy(state0, self.device)
        while True:
            self._build(n)
            supervisor = TrainingSupervisor(
                checkpointer=self.checkpointer,
                checkpoint_every=self.checkpoint_every,
                max_retries=self.max_retries,
                backoff_s=self.backoff_s,
                fatal=(DeviceLossFault,),
            )
            try:
                state, hist = supervisor.run(
                    state, self._step_fn, batches, n_steps, start_step=0)
                history.extend(hist)
                return state, history, self.report
            except DeviceLossFault as e:
                self.checkpointer.wait()   # flush any in-flight async save
                lost = [d for d in e.devices if d < n]
                survivors = n - len(lost)
                if survivors < 1:
                    raise
                last = supervisor.latest()
                self.report.replans.append({
                    "step": e.step, "period": e.period, "lost": lost,
                    "from_devices": n, "to_devices": survivors,
                    "resume_checkpoint": last,
                })
                self.report.resumed_from.append(
                    last if last is not None else -1)
                if last is None:
                    # no checkpoint yet: genuine from-scratch restart on
                    # the survivors — rewind state and the data pipeline.
                    state = _copy(state0, self.device)
                    if data_state0 is not None:
                        batches.restore(data_state0)
                n = survivors
