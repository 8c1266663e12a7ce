"""Lemma-1 elastic autoscaling for the serving engine, copied from the
reference ``repro/serve/elastic.py``.

The paper's core result — the closed-form optimal per-stage core count,
re-derived whenever the core set changes — is the allocation oracle here
as it is for training: ``runtime.elastic.ElasticPlanner`` wraps Lemma 1,
and ``ElasticPlanner.replan_program`` runs the degraded-mode machinery
(Lemma-1 plan on the survivors, period-program compile, static
validation), so a serving replan is priced and verified by the same code
path the fault-recovery tests pin.

Capacity policy: the decode batch (slot count) tracks the Lemma-1-priced
epoch throughput of the ring.  Losing cores makes the replanned epoch
slower, so the autoscaler shrinks the admitted batch proportionally
(protecting per-token latency instead of queueing decode work the ring
can no longer clear); a sustained TTFT SLO violation grows it back
toward ``max_slots`` after re-consulting the oracle.

Every decision is a ``ReplanDecision``, carrying the Lemma-1 core
allocation and the replanned epoch price that justified it.  The port's
ring is logical (``serve.runner``: n devices on one card), so a decision
rebuilds the runner's cache for the new slot count and nothing moves
between cards.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.nn_benchmarks import onoc_config, workload
from repro_torch.core.allocation import MappingStrategy
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.runtime.elastic import ElasticPlanner

__all__ = ["ReplanDecision", "ServeAutoscaler"]


@dataclasses.dataclass(frozen=True)
class ReplanDecision:
    """One autoscaling action: why, when, and the device/slot transition.

    ``epoch_s`` is the Lemma-1-replanned epoch price on ``to_devices``
    cores (compute + transitions, the program's cost annotations);
    ``lemma1_cores`` the per-stage optimal allocation that produced it
    (both unset when the engine decides without an autoscaler).
    """

    reason: str                       # "device_loss" | "slo_violation"
    at_s: float
    from_devices: int
    to_devices: int
    from_slots: int
    to_slots: int
    epoch_s: float | None = None
    lemma1_cores: tuple[int, ...] | None = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.lemma1_cores is not None:
            d["lemma1_cores"] = list(self.lemma1_cores)
        return d


def _default_workload() -> FCNNWorkload:
    return workload("NN1", batch_size=32)


def _default_cfg(n_devices: int) -> ONoCConfig:
    return dataclasses.replace(onoc_config(lambda_max=64), m=n_devices)


class ServeAutoscaler:
    """The serving engine's allocation oracle.

    ``on_device_loss`` re-runs Lemma 1 on the survivors (via
    ``ElasticPlanner.replan_program``, which also compiles and statically
    validates the survivors' period program — a bad replan fails here,
    before the engine rebuilds anything) and scales the slot count by the
    replanned epoch-throughput ratio.  ``on_slo_violation`` grows slots
    toward ``max_slots`` after re-deriving the allocation for the current
    membership; it returns None when already at capacity.
    """

    def __init__(self, n_devices: int, n_slots: int, *,
                 workload: FCNNWorkload | None = None,
                 base_cfg: ONoCConfig | None = None,
                 strategy: MappingStrategy = MappingStrategy.ORRM,
                 min_slots: int = 1, max_slots: int | None = None):
        self.workload = workload if workload is not None else _default_workload()
        self.base_cfg = (base_cfg if base_cfg is not None
                         else _default_cfg(n_devices))
        self.planner = ElasticPlanner(self.workload, self.base_cfg, strategy)
        self.n_devices = n_devices
        self.n_slots = n_slots
        self.base_slots = n_slots
        self.min_slots = min_slots
        self.max_slots = max_slots if max_slots is not None else 2 * n_slots
        self.events: list[ReplanDecision] = []
        self._base_epoch_s = self._replan(n_devices)[0]

    def _replan(self, n: int) -> tuple[float, tuple[int, ...]]:
        """Lemma 1 + compile + static validation on an ``n``-core ring;
        returns (epoch price, per-stage optimal cores)."""
        _, _, program = self.planner.replan_program(n)
        _, cores, _ = self.planner.plan_for(n)
        return float(program.compute_s + program.comm_s), tuple(cores)

    def _clamp(self, slots: int) -> int:
        return max(self.min_slots, min(self.max_slots, slots))

    def on_device_loss(self, n_lost: int, now: float) -> ReplanDecision:
        n_new = max(1, self.n_devices - n_lost)
        epoch_s, cores = self._replan(n_new)
        to_slots = self._clamp(round(
            self.base_slots * self._base_epoch_s / epoch_s))
        decision = ReplanDecision(
            reason="device_loss", at_s=now,
            from_devices=self.n_devices, to_devices=n_new,
            from_slots=self.n_slots, to_slots=to_slots,
            epoch_s=epoch_s, lemma1_cores=cores)
        self.n_devices = n_new
        self.n_slots = to_slots
        self.events.append(decision)
        return decision

    def on_slo_violation(self, now: float,
                         p99_ttft_s: float) -> ReplanDecision | None:
        to_slots = self._clamp(self.n_slots + max(1, self.n_slots // 2))
        if to_slots == self.n_slots:
            return None                      # already at capacity
        epoch_s, cores = self._replan(self.n_devices)
        decision = ReplanDecision(
            reason="slo_violation", at_s=now,
            from_devices=self.n_devices, to_devices=self.n_devices,
            from_slots=self.n_slots, to_slots=to_slots,
            epoch_s=epoch_s, lemma1_cores=cores)
        self.n_slots = to_slots
        self.events.append(decision)
        return decision
