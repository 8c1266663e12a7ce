"""Period-schedule execution engine, the PyTorch counterpart of the
reference's ``repro/exec/``.

The paper's fine-grained model gives every one of the 2l periods of an
FCNN training epoch its own core count, with a mapping strategy
(FM/RRM/ORRM) deciding how the active window moves between periods.  Here
those schedules are compiled and executed:

  * ``exec.program``  — the schedule compiler (a copy of the reference's):
    a planner plan plus a ``core.allocation.Mapping`` lowered to a static,
    serializable RUN/SEND/RECV/FREE program whose cost annotations are
    checked against ``core.simulator.simulate_epoch``.
  * ``exec.validate`` and ``exec.analysis`` — the static verifier and the
    per-device analyzer (copies): schedule invariants, the residency
    ledger, happens-before, chunk-level memory safety and shapes.
  * ``exec.residency`` — per-device live-bytes accounting (a copy).
  * ``exec.runtime``  — the executor, rewritten in PyTorch: n logical
    devices in one process on one ``torch.device``, each RUN chunk through
    the port's kernels (K1, with K2/K3 in the backward), the loss period
    through K4/K5, in sharded or replicated residency.
  * ``exec.api``      — the façade: ``repro_torch.exec.compile(workload,
    cfg, n_devices, strategy=..., residency=...) -> Executable`` with
    ``.init_state()`` / ``.train_step()`` / ``.loss_fn()`` /
    ``.degrade()``.

The reference's deprecated ``build_train_step`` is not ported.
"""

from repro_torch.exec.analysis import (  # noqa: F401
    AnalysisReport,
    ProgramAnalysisError,
    analyze_program,
    corruption_corpus,
    expand_program,
)
from repro_torch.exec.api import (  # noqa: F401
    Executable,
    compile,
)
from repro_torch.exec.program import (  # noqa: F401
    Instruction,
    Opcode,
    PeriodProgram,
    compile_fcnn_program,
    compile_program,
)
from repro_torch.exec.residency import (  # noqa: F401
    ResidencyTracker,
)
from repro_torch.exec.runtime import ProgramExecutor  # noqa: F401
from repro_torch.exec.validate import (  # noqa: F401
    ProgramValidationError,
    validate_program,
)

__all__ = [
    "compile",
    "Executable",
    "AnalysisReport",
    "ProgramAnalysisError",
    "analyze_program",
    "corruption_corpus",
    "expand_program",
    "Opcode",
    "Instruction",
    "PeriodProgram",
    "ResidencyTracker",
    "compile_program",
    "compile_fcnn_program",
    "ProgramExecutor",
    "ProgramValidationError",
    "validate_program",
]
