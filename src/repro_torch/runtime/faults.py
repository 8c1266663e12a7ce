"""Deterministic fault injection for the period-schedule execution engine,
copied from the reference's ``repro/runtime/faults.py`` (numpy and
``core`` only; ``tests/test_torch_faults.py`` holds the two equal).

Photonic substrates make degradation the *expected* operating regime —
thermal drift detunes ring resonators (wavelength loss), device variation
degrades links, and cores fail like anywhere else — so the repro carries a
first-class fault model instead of a happy-path executor.  Everything here
is seeded and replayable: the same ``FaultSchedule`` produces the same
faults at the same (step, period) boundaries every run.

Fault taxonomy (``FaultKind``):

  DEVICE_LOSS          a core leaves the ring permanently, mid-epoch.  The
                       recovery path (runtime/degraded.py) re-derives the
                       Lemma-1 plan on the survivors, recompiles the period
                       program, and resumes from the latest checkpoint.
  TRANSIENT_RUN        one period's RUN fails but the device survives
                       (SEU, kernel launch failure).  Cleared by bounded
                       retry with backoff (TrainingSupervisor).
  STRAGGLER            a period runs ``magnitude``× slow (thermal
                       throttling, contended link).  Observed by
                       StragglerMonitor / timeout hooks; inflates compute
                       in the pricing model.
  WAVELENGTH_DEGRADE   a fraction of the WDM comb is lost (ONoC): fewer
                       usable wavelengths => more TDM slots per transition.
  LINK_DEGRADE         a fraction of link capacity is lost: transition
                       drain times inflate by 1/(1-magnitude).

Injection points:

  * ``core.simulator.simulate_epoch(..., faults=EpochFaults(...))`` —
    fault-aware epoch *pricing* on both backends; see
    ``expected_epoch_time`` for the full failure-model price (degraded
    epoch + device-loss re-transition + replanned remainder).
  * ``FaultInjector.instruction_boundary`` — runtime injection: the
    degraded-mode runner walks the compiled program's instruction list
    each step and lets scheduled faults fire at instruction boundaries
    (raising ``TransientRunFault`` / ``DeviceLossFault``).

Every fired fault and every recovery action (retry, kernel fallback,
replan, timeout) is recorded in a structured ``FaultReport`` (the
reference's ``benchmarks/run.py --json`` serializes it).
"""

from __future__ import annotations

import dataclasses
import enum
import math
import time
from typing import Callable

import numpy as np

from repro_torch.core.onoc_model import (
    FCNNWorkload,
    ONoCConfig,
    optimal_cores,
)
from repro_torch.core.simulator import TransitionTraffic

__all__ = [
    "FaultKind",
    "FaultEvent",
    "FaultSchedule",
    "FaultError",
    "TransientRunFault",
    "DeviceLossFault",
    "KernelFault",
    "FaultReport",
    "FaultInjector",
    "EpochFaults",
    "FaultPricing",
    "expected_epoch_time",
]


class FaultKind(str, enum.Enum):
    DEVICE_LOSS = "device_loss"
    TRANSIENT_RUN = "transient_run"
    STRAGGLER = "straggler"
    WAVELENGTH_DEGRADE = "wavelength_degrade"
    LINK_DEGRADE = "link_degrade"


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``step``   training step (= one epoch of the paper's model) at which
               the fault fires.
    ``period`` instruction boundary within the step: the fault fires when
               the runner reaches period ``period``'s first instruction
               (0 = the very first boundary of the step).
    ``device`` target core (DEVICE_LOSS / TRANSIENT_RUN); None = unpinned.
    ``magnitude``  STRAGGLER: slowdown factor (>= 1);
                   *_DEGRADE: fraction of capacity lost in [0, 1).
    ``count``  how many times the fault fires before clearing — a
               TRANSIENT_RUN with count=2 fails two attempts and succeeds
               on the third (exercising bounded retry).
    """

    kind: FaultKind
    step: int
    period: int = 0
    device: int | None = None
    magnitude: float = 1.0
    count: int = 1

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self), "kind": self.kind.value}


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A deterministic, replayable set of fault events."""

    events: tuple[FaultEvent, ...] = ()
    seed: int | None = None

    @classmethod
    def sample(
        cls,
        seed: int,
        n_steps: int,
        n_devices: int,
        n_periods: int,
        rates: dict[FaultKind, float] | None = None,
    ) -> "FaultSchedule":
        """Bernoulli-per-step sampling of each fault kind at the given
        per-step rates — same seed, same schedule, every run."""
        rng = np.random.default_rng(seed)
        rates = rates or {}
        events: list[FaultEvent] = []
        for step in range(n_steps):
            for kind, rate in rates.items():
                if rng.random() >= rate:
                    continue
                events.append(FaultEvent(
                    kind=FaultKind(kind),
                    step=step,
                    period=int(rng.integers(1, max(n_periods, 1) + 1)),
                    device=int(rng.integers(n_devices)),
                    magnitude=(float(1.0 + 3.0 * rng.random())
                               if kind == FaultKind.STRAGGLER
                               else float(0.25 + 0.5 * rng.random())),
                ))
        return cls(events=tuple(events), seed=seed)

    @classmethod
    def seeded_device_loss(
        cls,
        seed: int,
        n_steps: int,
        n_devices: int,
        n_periods: int,
        n_lost: int = 1,
    ) -> "FaultSchedule":
        """One seeded mid-run, mid-epoch device-loss burst: the step is
        drawn from the middle of the run (so a checkpoint exists and steps
        remain), the period from within the epoch, the lost cores without
        replacement."""
        rng = np.random.default_rng(seed)
        lo, hi = max(1, n_steps // 3), max(2, 2 * n_steps // 3)
        step = int(rng.integers(lo, hi + 1))
        period = int(rng.integers(1, max(n_periods, 1) + 1))
        lost = rng.choice(n_devices, size=n_lost, replace=False)
        events = tuple(
            FaultEvent(kind=FaultKind.DEVICE_LOSS, step=step, period=period,
                       device=int(d))
            for d in sorted(int(d) for d in lost)
        )
        return cls(events=events, seed=seed)

    def at(self, step: int, period: int | None = None) -> tuple[FaultEvent, ...]:
        """Events scheduled for ``step`` (optionally at one period)."""
        return tuple(
            e for e in self.events
            if e.step == step and (period is None or e.period == period)
        )

    def device_losses(self, step: int | None = None) -> tuple[FaultEvent, ...]:
        return tuple(
            e for e in self.events
            if e.kind is FaultKind.DEVICE_LOSS
            and (step is None or e.step == step)
        )

    def transient_runs(self, step: int | None = None) -> tuple[FaultEvent, ...]:
        return tuple(
            e for e in self.events
            if e.kind is FaultKind.TRANSIENT_RUN
            and (step is None or e.step == step)
        )

    def to_dicts(self) -> list[dict]:
        return [e.to_dict() for e in self.events]


# --------------------------------------------------------------------------
# runtime injection
# --------------------------------------------------------------------------


class FaultError(RuntimeError):
    """Base class of all injected faults."""


class TransientRunFault(FaultError):
    """A RUN failed but the device survives — retryable."""

    def __init__(self, step: int, period: int, device: int | None):
        super().__init__(
            f"injected transient RUN failure at step {step}, period "
            f"{period} (device {device})")
        self.step, self.period, self.device = step, period, device


class DeviceLossFault(FaultError):
    """A device left the ring — not retryable, triggers replanning."""

    def __init__(self, step: int, period: int, devices: tuple[int, ...]):
        super().__init__(
            f"injected device loss at step {step}, period {period}: "
            f"devices {list(devices)} left the ring")
        self.step, self.period, self.devices = step, period, devices


class KernelFault(FaultError):
    """A kernel path failed; the executor degraded to the reference path."""


@dataclasses.dataclass
class FaultReport:
    """Structured record of injected faults and recovery actions — the
    machine-readable artifact the reference's ``benchmarks/run.py --json``
    stores."""

    fired: list[dict] = dataclasses.field(default_factory=list)
    retries: int = 0
    straggles: int = 0
    timeouts: int = 0
    kernel_fallbacks: int = 0
    replans: list[dict] = dataclasses.field(default_factory=list)
    resumed_from: list[int] = dataclasses.field(default_factory=list)

    def record(self, event: FaultEvent, **extra) -> None:
        self.fired.append({**event.to_dict(), **extra})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FaultInjector:
    """Fires a FaultSchedule at instruction boundaries and records
    everything in a FaultReport.

    ``sleep_scale`` scales STRAGGLER magnitudes into real wall-clock sleep
    seconds (0 = record-only, the CI-safe default).  ``timeout_s`` +
    ``on_timeout`` are the per-step timeout hook: ``observe_step`` compares
    each step's wall time against the budget and fires the hook on
    overrun (on a real cluster the hook would re-dispatch the shard).
    """

    schedule: FaultSchedule
    report: FaultReport = dataclasses.field(default_factory=FaultReport)
    sleep_scale: float = 0.0
    timeout_s: float | None = None
    on_timeout: Callable[[int, float], None] | None = None
    _fired_counts: dict[int, int] = dataclasses.field(default_factory=dict)

    def _fires(self, event: FaultEvent) -> bool:
        n = self._fired_counts.get(id(event), 0)
        if n >= event.count:
            return False
        self._fired_counts[id(event)] = n + 1
        return True

    def instruction_boundary(self, step: int, instr) -> None:
        """Called by the runner before each instruction of each step; may
        raise TransientRunFault / DeviceLossFault.  Period-0 events fire at
        the first boundary of the step (period-1 RUN)."""
        first = instr.period == 1 and getattr(instr.opcode, "value",
                                              instr.opcode) == "run"
        hits = [e for e in self.schedule.at(step)
                if e.period == instr.period or (e.period == 0 and first)]
        losses: list[FaultEvent] = []
        for e in hits:
            if e.kind is FaultKind.DEVICE_LOSS:
                if self._fires(e):
                    losses.append(e)
            elif e.kind is FaultKind.TRANSIENT_RUN:
                if self._fires(e):
                    self.report.retries += 1
                    self.report.record(e)
                    raise TransientRunFault(step, instr.period, e.device)
            elif e.kind is FaultKind.STRAGGLER:
                if self._fires(e):
                    self.report.straggles += 1
                    self.report.record(e)
                    if self.sleep_scale > 0:
                        time.sleep(e.magnitude * self.sleep_scale)
            else:  # degradation faults are pricing-level; record once
                if self._fires(e):
                    self.report.record(e)
        if losses:
            devs = tuple(sorted({e.device for e in losses
                                 if e.device is not None}))
            for e in losses:
                self.report.record(e)
            raise DeviceLossFault(step, instr.period, devs)

    def observe_step(self, step: int, duration_s: float) -> None:
        if self.timeout_s is not None and duration_s > self.timeout_s:
            self.report.timeouts += 1
            if self.on_timeout is not None:
                self.on_timeout(step, duration_s)


# --------------------------------------------------------------------------
# simulator-side pricing
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EpochFaults:
    """The simulator's view of one step's non-fatal faults — the object
    ``core.simulator.simulate_epoch`` accepts as ``faults=``.

    ``wavelength_loss``  fraction of the WDM comb lost (ONoC: lambda_max
                         shrinks, so each transition needs more TDM slots).
    ``link_degrade``     period -> fraction of link capacity lost (0 = all
                         periods); transition time inflates by 1/(1-f) on
                         either backend.
    ``straggle``         period -> compute slowdown factor >= 1 (0 = all).
    """

    wavelength_loss: float = 0.0
    link_degrade: dict[int, float] = dataclasses.field(default_factory=dict)
    straggle: dict[int, float] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_schedule(cls, schedule: FaultSchedule,
                      step: int | None = None) -> "EpochFaults":
        wl = 0.0
        link: dict[int, float] = {}
        strag: dict[int, float] = {}
        for e in schedule.events:
            if step is not None and e.step != step:
                continue
            if e.kind is FaultKind.WAVELENGTH_DEGRADE:
                wl = 1.0 - (1.0 - wl) * (1.0 - e.magnitude)
            elif e.kind is FaultKind.LINK_DEGRADE:
                prev = link.get(e.period, 0.0)
                link[e.period] = 1.0 - (1.0 - prev) * (1.0 - e.magnitude)
            elif e.kind is FaultKind.STRAGGLER:
                strag[e.period] = max(strag.get(e.period, 1.0), e.magnitude)
        return cls(wavelength_loss=wl, link_degrade=link, straggle=strag)

    # --- hooks consumed by core.simulator.simulate_epoch ---

    def apply_config(self, cfg: ONoCConfig) -> ONoCConfig:
        if self.wavelength_loss <= 0.0:
            return cfg
        lam = max(1, int(math.floor(
            cfg.lambda_max * (1.0 - self.wavelength_loss))))
        return dataclasses.replace(cfg, lambda_max=lam)

    def compute_scale(self, period: int) -> float:
        return max(self.straggle.get(period, 1.0), self.straggle.get(0, 1.0))

    def apply_transition(self, tr: TransitionTraffic,
                         period: int) -> TransitionTraffic:
        lost = max(self.link_degrade.get(period, 0.0),
                   self.link_degrade.get(0, 0.0))
        if lost <= 0.0:
            return tr
        cap = max(1.0 - lost, 1e-9)
        return dataclasses.replace(tr, comm_s=tr.comm_s / cap)


@dataclasses.dataclass(frozen=True)
class FaultPricing:
    """Epoch price under a failure model (see ``expected_epoch_time``).

    ``strategy`` is the normalized mapping-strategy value every component
    of the price was simulated under — retry/prefix pricing only matches
    a ``simulate_epoch`` cross-check run under the *same* strategy (note
    the defaults differ: ``expected_epoch_time`` prices ORRM while
    ``simulate_epoch`` defaults to FM), so the constructor rejects
    anything that is not a valid ``MappingStrategy`` value.
    """

    backend: str
    strategy: str
    nominal_s: float            # fault-free epoch
    degraded_s: float           # epoch under non-fatal degradations
    loss_period: int | None     # first device-loss boundary (None = none)
    survivors: int              # cores after all losses at this step
    prefix_s: float             # work completed before the loss boundary
    re_transition_s: float      # state re-load onto the surviving window
    replanned_epoch_s: float    # Lemma-1 epoch on the surviving core set
    expected_s: float           # the headline number
    retry_s: float = 0.0        # wasted work re-done for TRANSIENT_RUN
    retries: int = 0            # total retry attempts priced

    def __post_init__(self) -> None:
        from repro_torch.core.allocation import MappingStrategy

        try:
            normalized = MappingStrategy(self.strategy).value
        except ValueError:
            raise ValueError(
                f"FaultPricing.strategy {self.strategy!r} is not a "
                f"MappingStrategy value "
                f"({[s.value for s in MappingStrategy]})") from None
        if normalized != self.strategy:
            object.__setattr__(self, "strategy", normalized)

    @property
    def overhead_pct(self) -> float:
        return 100.0 * (self.expected_s / self.nominal_s - 1.0)


def _retransition_cost(workload: FCNNWorkload, cfg: ONoCConfig,
                       survivors: int, backend) -> float:
    """Price of re-loading the full model state onto the surviving window
    after a device loss (checkpoint replay, epoch-granular recovery).

    ONoC: one TDM round of per-sender setups (ceil(m'/λ) slots) plus the
    full-state payload streamed over the comb.  ENoC: the same payload
    drained at one link's effective bandwidth plus per-core setup —
    deliberately simple, documented models; both monotone in state size
    and decreasing in surviving-core bandwidth.
    """
    total_values = sum(
        (workload.n(i - 1) + 1) * workload.n(i)
        for i in range(1, workload.l + 1)
    )
    if getattr(backend, "name", "onoc") == "enoc":
        payload_bytes = total_values * cfg.bytes_per_value
        bw = backend.enoc.effective_link_bandwidth_Bps()
        return survivors * cfg.setup_time_s + payload_bytes / bw
    slots = math.ceil(survivors / cfg.lambda_max)
    return slots * cfg.setup_time_s + cfg.payload_time_s(total_values)


def expected_epoch_time(
    workload: FCNNWorkload,
    cfg: ONoCConfig,
    schedule: FaultSchedule,
    step: int | None = None,
    strategy="orrm",
    backend=None,
    refine_plateau: bool = True,
) -> FaultPricing:
    """Fault-aware epoch pricing on either backend.

    Without device loss the price is the degraded epoch (wavelength/link/
    straggler faults applied through ``EpochFaults``).  With device loss at
    period p the failure model is:

        E[T] = prefix(degraded, < p)        work completed before the loss
             + re_transition(survivors)     state re-load onto the window
             + T*(survivors)                Lemma-1 replanned epoch on the
                                            surviving core set (recovery is
                                            epoch-granular: the interrupted
                                            epoch restarts from checkpoint)

    which is exactly what the degraded-mode runner executes
    (runtime/degraded.py): replan, recompile, resume-from-checkpoint.

    TRANSIENT_RUN events are priced as retry waste: the supervisor's
    retry restarts the step from its beginning, so a transient at period
    p that fails ``count`` attempts re-does the degraded prefix through
    period p's RUN (compute of periods 1..p + transitions before p)
    ``count`` times.  With a device loss at boundary p_loss only
    transients strictly before p_loss are priced — later boundaries are
    never reached, and post-replan retries belong to the next epoch's
    price.  ``retry_s`` carries the total; ``expected_s`` includes it.
    """
    from repro_torch.core.allocation import MappingStrategy
    from repro_torch.core.simulator import ONoCBackend, simulate_epoch

    # normalize early: every priced component (nominal, degraded, retry
    # prefixes, the replanned epoch) must use one strategy, and the
    # resulting FaultPricing.strategy must name it exactly — note the
    # default here is "orrm" while simulate_epoch defaults to FM, so
    # cross-checks must pass pricing.strategy explicitly.
    strategy = MappingStrategy(strategy).value
    backend = backend or ONoCBackend()
    ef = EpochFaults.from_schedule(schedule, step)
    nominal = simulate_epoch(workload, cfg, strategy=strategy,
                             backend=backend)
    degraded = simulate_epoch(workload, cfg, strategy=strategy,
                              backend=backend, faults=ef)
    n_periods = 2 * workload.l

    def _retry_cost(before_period: int | None) -> tuple[float, int]:
        transients = (schedule.transient_runs(step) if step is not None
                      else schedule.transient_runs())
        total, n_retries = 0.0, 0
        for e in transients:
            p = min(max(e.period, 1), n_periods)  # 0 = first RUN boundary
            if before_period is not None and p >= before_period:
                continue
            n = max(e.count, 1)
            wasted = (sum(degraded.per_period_compute_s[:p])
                      + sum(t.comm_s for t in degraded.transitions
                            if t.period < p))
            total += n * wasted
            n_retries += n
        return total, n_retries

    losses = (schedule.device_losses(step) if step is not None
              else schedule.device_losses())
    if not losses:
        retry_s, retries = _retry_cost(None)
        return FaultPricing(
            backend=backend.name, strategy=nominal.strategy,
            nominal_s=nominal.total_s, degraded_s=degraded.total_s,
            loss_period=None, survivors=cfg.m, prefix_s=degraded.total_s,
            re_transition_s=0.0, replanned_epoch_s=0.0,
            expected_s=degraded.total_s + retry_s,
            retry_s=retry_s, retries=retries,
        )

    p = min(max(e.period, 1) for e in losses)
    survivors = cfg.m - len({e.device for e in losses})
    if survivors < 1:
        raise ValueError("device loss leaves no surviving cores")

    prefix = sum(degraded.per_period_compute_s[: p - 1])
    prefix += sum(t.comm_s for t in degraded.transitions if t.period < p)
    re_tr = _retransition_cost(workload, cfg, survivors, backend)
    retry_s, retries = _retry_cost(p)

    cfg_surv = dataclasses.replace(cfg, m=survivors)
    cores = optimal_cores(workload, cfg_surv, refine_plateau=refine_plateau)
    cores = [min(c, survivors) for c in cores]
    replanned = simulate_epoch(workload, cfg_surv, strategy=strategy,
                               cores_per_period=cores, backend=backend,
                               faults=ef)

    expected = prefix + retry_s + re_tr + replanned.total_s
    return FaultPricing(
        backend=backend.name, strategy=nominal.strategy,
        nominal_s=nominal.total_s, degraded_s=degraded.total_s,
        loss_period=p, survivors=survivors, prefix_s=prefix,
        re_transition_s=re_tr, replanned_epoch_s=replanned.total_s,
        expected_s=expected, retry_s=retry_s, retries=retries,
    )
