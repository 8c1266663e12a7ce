"""One-call plan -> compile -> validate -> execute façade, the PyTorch
counterpart of the reference's ``repro/exec/api.py``:

    exe = repro_torch.exec.compile(workload, cfg, n_devices=8,
                                   strategy="orrm", residency="sharded")
    state = exe.init_state(torch.Generator().manual_seed(0), optimizer)
    step = exe.train_step(optimizer)
    state, metrics = step(state, batch)

The n devices are logical: one process runs the whole ring on one
``torch.device`` (``exec/runtime.py``), the card unless the caller asks
for the CPU.  ``residency`` selects the params layout: ``"sharded"``
(default) keeps each device's resident parameters to its column chunks,
state in the stacked layout of ``Executable.shard_params``;
``"replicated"`` holds the full model on every device and serves as the
oracle the sharded path is held to, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.allocation import MappingStrategy
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.core.planner import FCNNPlan, plan_fcnn, ring_mesh_axes
from repro_torch.exec.analysis import analyze_program
from repro_torch.exec.program import PeriodProgram, compile_program
from repro_torch.exec.runtime import ProgramExecutor
from repro_torch.models import fcnn
from repro_torch.optim.optimizers import (
    Optimizer,
    clip_by_global_norm,
    global_norm,
)

Params = dict[str, Any]

__all__ = ["Executable", "compile"]


@dataclasses.dataclass
class Executable:
    """A compiled, validated period program bound to its executor, ready to
    train.

    Produced by ``repro_torch.exec.compile`` (or ``from_program`` when the
    ``PeriodProgram`` already exists, e.g. deserialized).  The residency
    mode fixes the params layout of every method: ``init_state``,
    ``train_step`` and ``loss_fn`` speak the stacked chunk layout in
    sharded mode and the full layout in replicated mode;
    ``shard_params``/``gather_params`` convert.
    """

    program: PeriodProgram
    executor: ProgramExecutor
    residency: str
    workload: FCNNWorkload | None = None
    cfg: ONoCConfig | None = None
    plan: FCNNPlan | None = None
    backend: Any = None

    @classmethod
    def from_program(cls, program: PeriodProgram,
                     residency: str = "sharded",
                     kernel_mode: str | None = None,
                     device: str | torch.device | None = None,
                     workload: FCNNWorkload | None = None,
                     cfg: ONoCConfig | None = None,
                     plan: FCNNPlan | None = None,
                     backend: Any = None,
                     analyze: str = "off") -> "Executable":
        """Bind an existing program to an executor on ``device``.
        ``analyze`` defaults to ``"off"`` because ``compile`` analyzes
        before binding; pass ``"fast"``/``"full"`` for programs from
        untrusted sources (deserialized files)."""
        if analyze != "off":
            analyze_program(program, workload, cfg, backend=backend,
                            level=analyze)
        ex = ProgramExecutor(program, device=device, kernel_mode=kernel_mode,
                             residency=residency)
        return cls(program=program, executor=ex, residency=residency,
                   workload=workload, cfg=cfg, plan=plan, backend=backend)

    # -------------------------------------------------------------- layout

    @property
    def device(self) -> torch.device:
        return self.executor.device

    @property
    def tracker(self):
        """ResidencyTracker of the executor's layout (exec.residency)."""
        return self.executor.tracker

    @property
    def kernel_mode(self) -> str | None:
        return self.executor.kernel_mode

    def shard_params(self, params: Params) -> Params:
        return self.executor.shard_params(params)

    def gather_params(self, sparams: Params) -> Params:
        return self.executor.gather_params(sparams)

    # ----------------------------------------------------------- training

    def loss_fn(self, params: Params, batch: Params) -> torch.Tensor:
        """Program loss in the executable's residency layout
        (differentiable)."""
        return self.executor.loss_fn(params, batch)

    def init_state(self, generator: torch.Generator, optimizer: Optimizer,
                   params: dict | None = None) -> Params:
        """Fresh ``{"params", "opt", "step"}`` state in the residency
        layout, on the executor's device.  The weights are drawn from
        ``generator`` by ``models.fcnn.init``, or taken from ``params``,
        the reference's full-layout tree as numpy arrays.  Optimizer moments
        mirror the params, so in sharded mode they are chunked too:
        off-window zero slots get zero gradients and stay exactly zero."""
        if params is None:
            params = fcnn.init(self.program.layer_sizes, generator,
                               self.device)
        else:
            params = fcnn.params_from_numpy(params, self.device)
        if self.residency == "sharded":
            params = self.shard_params(params)
        return {"params": params, "opt": optimizer.init(params),
                "step": torch.zeros((), dtype=torch.float32,
                                    device=self.device)}

    def train_step(self, optimizer: Optimizer,
                   grad_clip: float | None = None) -> Callable:
        """``step(state, batch) -> (state, {"loss", "grad_norm"})`` over the
        executable's loss.  The step updates ``state`` in place (the
        params, the optimizer's moments and the fp32 step counter) and
        reads nothing back from the device, so the reference's buffer
        donation has no counterpart here.  ``grad_clip`` adds global-norm
        clipping (the norm reduces over chunked leaves in sharded mode, so
        clipped trajectories agree with the replicated ones only to fp
        tolerance; unclipped element-wise optimizers agree bit for bit)."""
        ex = self.executor

        def step(state: Params, batch: Params):
            params = state["params"]
            leaves = fcnn.parameters(params)
            loss = ex.loss_fn(params, batch)
            it = iter(torch.autograd.grad(loss, leaves))
            grads = {"layers": [{"w": next(it), "b": next(it)}
                                for _ in params["layers"]]}
            if grad_clip is not None:
                grads, gnorm = clip_by_global_norm(grads, grad_clip)
            else:
                gnorm = global_norm(grads)
            optimizer.update(grads, state["opt"], params, state["step"])
            state["step"] += 1.0
            return state, {"loss": loss.detach(), "grad_norm": gnorm}

        return step

    # ----------------------------------------------------------- recovery

    def degrade(self, mode: str | None = "ref") -> str | None:
        """Switch the kernel dispatch (``ProgramExecutor.degrade``) and
        return the previous mode; steps built before the call see the
        switch too."""
        return self.executor.degrade(mode)


def compile(  # noqa: A001 — deliberate façade name, repro_torch.exec.compile
    workload: FCNNWorkload,
    cfg: ONoCConfig,
    n_devices: int,
    strategy: MappingStrategy | str = MappingStrategy.ORRM,
    residency: str = "sharded",
    backend: Any = None,
    kernel_mode: str | None = None,
    analyze: str = "full",
    device: str | torch.device | None = None,
) -> Executable:
    """Plan (Lemma 1 on the divisor-complete ring of ``n_devices``),
    compile and statically validate the period program, analyze it, and
    bind it to an executor on ``device`` (``None``: the card) in the
    requested residency mode.

    ``analyze`` selects the static-analysis level (``exec.analysis``):
    ``"full"`` (default) adds the per-device happens-before and memory
    checks and the shape abstract interpreter to the validator; ``"fast"``
    skips the shape interpreter and the cost contract; ``"off"`` leaves
    only the validator built into ``compile_program``.
    """
    plan = plan_fcnn(workload, cfg, ring_mesh_axes(n_devices),
                     strategy=strategy)
    program = compile_program(plan, workload, cfg, n_devices,
                              backend=backend)
    if analyze != "off":
        analyze_program(program, workload, cfg, backend=backend,
                        level=analyze)
    return Executable.from_program(
        program, residency=residency, kernel_mode=kernel_mode, device=device,
        workload=workload, cfg=cfg, plan=plan, backend=backend)
