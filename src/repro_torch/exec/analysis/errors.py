"""Shared error types for the static program analyzer.

``ProgramAnalysisError`` subclasses ``ProgramValidationError`` so every
existing ``except ProgramValidationError`` site (degraded-mode replans,
compile-time guards, tests) also catches analyzer rejections — the
analyzer is a strictly stronger verifier layered on the same contract,
not a parallel error taxonomy.
"""

from __future__ import annotations

from repro_torch.exec.validate import ProgramValidationError

__all__ = ["ProgramAnalysisError", "ProgramValidationError"]


class ProgramAnalysisError(ProgramValidationError):
    """Per-device static analysis rejected the program.

    Raised by ``exec.analysis.analyze_program`` when the per-device
    expansion, the happens-before graph, or the shape abstract
    interpreter finds a defect that the SPMD-level validator
    (``exec.validate.validate_program``) cannot see: communication
    deadlocks, swapped SEND/RECV endpoints, use-after-FREE /
    use-before-def / double-FREE at chunk granularity, and
    shape/dtype/activation mismatches against the workload.
    """
