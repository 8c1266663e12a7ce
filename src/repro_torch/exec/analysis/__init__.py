"""Static program analysis for compiled period programs, copied from the
reference ``repro/exec/analysis/`` (as are the modules of this package).

``exec.validate`` checks a ``PeriodProgram`` at the SPMD/ledger level;
this package expands the program to one concrete instruction stream per
device and verifies what only that view can see:

  * ``expand``  — the per-device expander (window membership, chunk
    geometry, SEND/RECV endpoints resolved statically);
  * ``hb``      — happens-before graph over the streams: communication
    deadlocks (cyclic waits), unmatched/misordered SEND/RECV endpoints,
    per-device use-before-def, use-after-FREE and double-FREE at chunk
    granularity;
  * ``shapes``  — shape/dtype abstract interpretation of the activation
    and cotangent flow, cross-checked against the workload;
  * ``corpus``  — a seeded corruption corpus that the validator passes
    but the analyzer must reject (regression fixture for all of the
    above).

Entry point::

    report = analyze_program(program, workload, cfg, level="full")

``level`` trades coverage for time: ``"off"`` skips analysis entirely,
``"fast"`` runs the validator's structural pre-pass plus the per-device
expansion and happens-before/memory checks, ``"full"`` adds the cost
contract (workload+cfg) and the shape abstract interpreter.  It runs at
compile time (``repro_torch.exec.compile(analyze=...)``).  All rejections
raise ``ProgramAnalysisError`` — a subclass of ``ProgramValidationError``, so
existing handlers keep working.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.exec.analysis.corpus import (  # noqa: F401
    CorruptedProgram,
    corruption_corpus,
)
from repro_torch.exec.analysis.errors import ProgramAnalysisError  # noqa: F401
from repro_torch.exec.analysis.expand import (  # noqa: F401
    DeviceOp,
    expand_program,
    n_device_ops,
)
from repro_torch.exec.analysis.hb import (  # noqa: F401
    check_endpoints,
    check_happens_before,
    check_memory,
)
from repro_torch.exec.analysis.shapes import check_shapes  # noqa: F401
from repro_torch.exec.program import PeriodProgram
from repro_torch.exec.validate import validate_program

__all__ = [
    "AnalysisReport",
    "CorruptedProgram",
    "DeviceOp",
    "ProgramAnalysisError",
    "analyze_program",
    "check_endpoints",
    "check_happens_before",
    "check_memory",
    "check_shapes",
    "corruption_corpus",
    "expand_program",
    "n_device_ops",
]

LEVELS = ("off", "fast", "full")


@dataclasses.dataclass(frozen=True)
class AnalysisReport:
    """What the analyzer looked at — sized for benchmark reporting."""

    level: str
    n_devices: int
    n_instructions: int
    n_device_ops: int
    n_hb_edges: int
    checks: tuple[str, ...]


def analyze_program(
    program: PeriodProgram,
    workload: FCNNWorkload | None = None,
    cfg: ONoCConfig | None = None,
    backend=None,
    level: str = "full",
) -> AnalysisReport | None:
    """Statically analyze ``program``; raise on the first defect found.

    Check order (first failure wins): the SPMD validator as a fast
    pre-pass, then endpoint matching, the happens-before graph, the
    per-device memory walk, and (``"full"`` only) the shape/dtype
    abstract interpreter.  Returns an ``AnalysisReport`` (``None`` at
    level ``"off"``).
    """
    if level not in LEVELS:
        raise ValueError(f"analyze level must be one of {LEVELS}, "
                         f"got {level!r}")
    if level == "off":
        return None

    checks = ["validate"]
    if level == "full":
        validate_program(program, workload, cfg, backend=backend)
    else:
        validate_program(program)

    streams = expand_program(program)
    check_endpoints(program)
    n_edges = check_happens_before(streams)
    fp_windows = {r.layer: r.devices for r in program.runs("fp")}
    check_memory(streams, l=program.l, fp_windows=fp_windows,
                 check_params=program.version >= 2)
    checks += ["expand", "endpoints", "happens-before", "memory"]

    if level == "full":
        check_shapes(program, workload, cfg)
        checks.append("shapes")

    return AnalysisReport(
        level=level,
        n_devices=program.n_devices,
        n_instructions=len(program.instructions),
        n_device_ops=n_device_ops(streams),
        n_hb_edges=n_edges,
        checks=tuple(checks),
    )
