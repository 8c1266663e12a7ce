"""Elastic scaling: the ONoC allocator is the re-planning oracle.

The planning half of the reference's ``repro/runtime/elastic.py``: when
the ring's membership changes (a device lost), the paper's model answers
"how many workers should each stage use now?" — Lemma 1 with the new m —
and ``replan_program`` compiles the period program for the survivors.

The reference's ``make_mesh`` and ``remesh_state`` have no counterpart:
the port's ring is logical, n devices of one process on one card with no
mesh (``exec/runtime.py``).  Their job, moving state between layouts, is
``Executable.shard_params`` / ``gather_params``, and the degraded-mode
runner keeps its state in the full layout that every ring shares
(``runtime/degraded.py``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.allocation import MappingStrategy, map_cores
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig, optimal_cores
from repro_torch.core.planner import plan_fcnn, ring_mesh_axes
from repro_torch.exec.program import compile_program

__all__ = ["ElasticPlanner"]


@dataclasses.dataclass
class ElasticPlanner:
    workload: FCNNWorkload
    base_cfg: ONoCConfig
    strategy: MappingStrategy = MappingStrategy.ORRM

    def plan_for(self, n_devices: int):
        """Re-run the paper's allocator for a new device count."""
        cfg = dataclasses.replace(self.base_cfg, m=n_devices)
        cores = optimal_cores(self.workload, cfg, refine_plateau=True)
        cores = [min(c, n_devices) for c in cores]
        mapping = map_cores(self.workload, cfg, self.strategy, cores)
        return cfg, cores, mapping

    def replan_program(self, n_devices: int, backend=None):
        """Degraded-mode replan: Lemma-1 plan on the surviving ring plus a
        freshly compiled (and statically validated) period program for it.

        Returns ``(cfg, plan, program)`` where ``cfg`` is the base config
        shrunk to ``n_devices`` cores.  ``compile_program`` re-runs the
        static verifier on the new schedule, so a bad replan is a hard
        ``ProgramValidationError`` before anything executes.
        """
        cfg = dataclasses.replace(self.base_cfg, m=n_devices)
        plan = plan_fcnn(self.workload, cfg, ring_mesh_axes(n_devices),
                         strategy=self.strategy)
        program = compile_program(plan, self.workload, cfg, n_devices,
                                  backend=backend)
        return cfg, plan, program
