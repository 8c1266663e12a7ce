"""Traditional parallel-computing baselines the paper compares against

Copied from the reference ``repro/core/baselines.py``, unchanged.
(Section 5.3):

  FGP — Finest-Grained Parallel [28]: one neuron per core,
        m_i = min(n_i, φ·m).
  FNP — Fixed Number Parallel [29]: a fixed core count (200 in the paper)
        for every period, m_i = min(fixed, n_i, φ·m).
"""

from __future__ import annotations

from .onoc_model import FCNNWorkload, ONoCConfig

__all__ = ["fgp_cores", "fnp_cores"]


def fgp_cores(workload: FCNNWorkload, cfg: ONoCConfig) -> list[int]:
    cap = int(cfg.phi * cfg.m)
    return [min(workload.n(i), cap) for i in range(1, workload.l + 1)]


def fnp_cores(
    workload: FCNNWorkload, cfg: ONoCConfig, fixed: int = 200
) -> list[int]:
    cap = int(cfg.phi * cfg.m)
    return [min(fixed, workload.n(i), cap) for i in range(1, workload.l + 1)]
