"""Admission + continuous-batching scheduler, copied from the reference
``repro/serve/scheduler.py``.

Admission is per-slot: a newly admitted request is prefilled alone
(batch-1, shape-bucketed) and its cache rows are merged into the batch
cache at its slot index only — an in-flight slot's cache state is never
touched by someone else's admission.  Prefill and decode are separate
steps: each engine iteration first admits + prefills into free slots,
then runs exactly one batched decode step for everything resident.

The engine is model-agnostic: it drives a ``ModelRunner`` (the PyTorch
implementation lives in ``serve.runner``; tests substitute a fake) and a
``Clock`` (wall clock for real serving, ``TickClock`` for deterministic
virtual-time tests).

Elasticity: a device-loss event (scenario-scheduled) or a sustained SLO
violation consults the autoscaler (``serve.elastic.ServeAutoscaler`` —
Lemma 1 on the survivors) when one is given; without one a device loss
takes the engine's own ``ReplanDecision`` (the survivors, at least one
device, same slots).  The runner is rebuilt for the new device count and
slot count, and every in-flight request is restarted from its prompt:
greedy decode is a pure function of the prompt, so the replayed stream is
identical and the fault costs latency, never tokens.  Queued and
restarted requests are re-admitted in arrival order (FIFO fairness).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Protocol

import numpy as np

from repro_torch.serve.elastic import ReplanDecision
from repro_torch.serve.metrics import ServeMetrics, SLOReport
from repro_torch.serve.traffic import Scenario, TrafficTrace, prompt_tokens

__all__ = [
    "Request",
    "SlotManager",
    "ModelRunner",
    "TickClock",
    "WallClock",
    "ServingEngine",
    "EngineResult",
]


@dataclasses.dataclass
class Request:
    """One in-flight request.  ``out`` accumulates generated tokens (the
    prefill's first token included); ``done`` flips when ``gen_len``
    tokens exist."""

    rid: int
    prompt: np.ndarray
    gen_len: int
    arrival_s: float = 0.0
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    restarts: int = 0

    @property
    def max_new(self) -> int:        # old launch.serve.Request field name
        return self.gen_len


class SlotManager:
    """Continuous batching over a fixed-size slot set.

    Invariants (pinned by tests/test_serve_scheduler.py):
      * a request occupies at most one slot at a time;
      * ``fill`` admits strictly in queue (FIFO) order;
      * ``release_done`` moves a finished request to ``finished`` exactly
        once and frees its slot.
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("n_slots >= 1")
        self.slots: list[Request | None] = [None] * n_slots
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def fill(self) -> list[tuple[int, Request]]:
        """Assign queued requests to free slots in FIFO order; returns the
        newly filled (slot, request) pairs."""
        assigned: list[tuple[int, Request]] = []
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                req = self.queue.popleft()
                if any(r is req for r in self.slots):
                    raise RuntimeError(
                        f"request {req.rid} already occupies a slot")
                self.slots[i] = req
                assigned.append((i, req))
        return assigned

    def release_done(self) -> list[Request]:
        out = []
        for i, s in enumerate(self.slots):
            if s is not None and s.done:
                self.finished.append(s)
                self.slots[i] = None
                out.append(s)
        return out

    def running(self) -> list[tuple[int, Request]]:
        return [(i, s) for i, s in enumerate(self.slots)
                if s is not None and not s.done]

    def drain_slots(self) -> list[Request]:
        """Pull every resident request out of its slot (capacity change:
        the caller restarts + resubmits them)."""
        out = [s for s in self.slots if s is not None]
        self.slots = [None] * len(self.slots)
        return out

    @property
    def active(self) -> bool:
        return any(s is not None for s in self.slots) or bool(self.queue)


class ModelRunner(Protocol):
    """What the engine needs from a model backend."""

    vocab: int
    n_devices: int

    def prefill(self, slot: int, prompt: np.ndarray) -> int:
        """Prefill one request into ``slot`` (merging only that slot's
        cache rows) and return its first generated token."""
        ...

    def decode(self, last_tokens: np.ndarray) -> np.ndarray:
        """One batched greedy decode step: (n_slots,) int32 in/out."""
        ...

    def rebuild(self, n_devices: int | None = None,
                n_slots: int | None = None) -> None:
        """Re-place params and rebuild steps for a new device count and/or
        slot count (all cache state is discarded)."""
        ...


class TickClock:
    """Virtual time for deterministic tests: each engine phase advances a
    fixed dt, idle periods jump to the next arrival."""

    def __init__(self, dt: float = 1.0):
        self.dt = dt
        self._t = 0.0

    def now(self) -> float:
        return self._t

    def advance(self, dt: float | None = None) -> None:
        self._t += self.dt if dt is None else dt

    def skip_to(self, t: float) -> None:
        self._t = max(self._t, t)


class WallClock:
    """Real time, with idle periods skipped instantly: latencies are real
    compute/queueing time, but an idle open-loop gap costs nothing."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._offset = 0.0

    def now(self) -> float:
        return time.perf_counter() - self._t0 + self._offset

    def advance(self, dt: float | None = None) -> None:
        pass                                    # real time advances itself

    def skip_to(self, t: float) -> None:
        now = self.now()
        if t > now:
            self._offset += t - now


@dataclasses.dataclass
class EngineResult:
    streams: dict[int, list[int]]            # rid -> generated tokens
    metrics: ServeMetrics
    slo: SLOReport
    n_prefills: int
    n_decode_steps: int
    replans: list                            # ReplanDecision


class ServingEngine:
    """Open-loop engine: admits trace arrivals, prefills into free slots,
    decodes the resident batch, and reacts to device loss / SLO pressure
    via the autoscaler."""

    def __init__(self, runner: ModelRunner, n_slots: int,
                 clock=None, autoscaler=None,
                 slo_check_every: int = 0, slo_patience: int = 2,
                 slo_window: int = 8):
        self.runner = runner
        self.n_slots = n_slots
        self.clock = clock
        self.autoscaler = autoscaler
        self.slo_check_every = slo_check_every
        self.slo_patience = slo_patience
        self.slo_window = slo_window

    # -- elastic transitions ------------------------------------------------

    def _rescale(self, mgr: SlotManager, metrics: ServeMetrics,
                 decision) -> SlotManager:
        """Apply a ReplanDecision: rebuild the runner, restart in-flight
        requests from their prompts, re-admit everything in arrival
        order."""
        inflight = mgr.drain_slots()
        for req in inflight:
            req.out = []
            req.done = False
            req.restarts += 1
            metrics.on_restart(req.rid)
        backlog = sorted([*inflight, *mgr.queue],
                         key=lambda r: (r.arrival_s, r.rid))
        self.runner.rebuild(n_devices=decision.to_devices,
                            n_slots=decision.to_slots)
        new_mgr = SlotManager(decision.to_slots)
        new_mgr.finished = mgr.finished
        for req in backlog:
            new_mgr.submit(req)
        return new_mgr

    def _device_loss(self, mgr: SlotManager, metrics: ServeMetrics,
                     n_lost: int, now: float, replans: list) -> SlotManager:
        if self.autoscaler is not None:
            decision = self.autoscaler.on_device_loss(n_lost, now)
        else:
            decision = ReplanDecision(
                reason="device_loss", at_s=now,
                from_devices=self.runner.n_devices,
                to_devices=max(1, self.runner.n_devices - n_lost),
                from_slots=mgr.n_slots, to_slots=mgr.n_slots)
        replans.append(decision)
        return self._rescale(mgr, metrics, decision)

    # -- main loop ----------------------------------------------------------

    def run(self, trace: TrafficTrace,
            scenario: Scenario | None = None) -> EngineResult:
        clock = self.clock if self.clock is not None else WallClock()
        metrics = ServeMetrics()
        mgr = SlotManager(self.n_slots)
        replans: list = []
        streams: dict[int, list[int]] = {}
        pending = deque(sorted(trace.events,
                               key=lambda e: (e.arrival_s, e.rid)))
        loss_at, loss_n = (scenario.device_loss
                           if scenario is not None and scenario.device_loss
                           else (None, 0))
        n_prefills = n_decode_steps = 0
        slo_strikes = 0

        def release(now: float) -> None:
            for req in mgr.release_done():
                metrics.on_finish(req.rid, now, n_gen=len(req.out))
                streams[req.rid] = list(req.out)

        while pending or mgr.active:
            now = clock.now()
            # 1. open-loop arrivals
            while pending and pending[0].arrival_s <= now:
                ev = pending.popleft()
                req = Request(
                    rid=ev.rid,
                    prompt=prompt_tokens(trace.seed, ev, self.runner.vocab),
                    gen_len=ev.gen_len, arrival_s=ev.arrival_s)
                mgr.submit(req)
                metrics.on_submit(ev.rid, ev.arrival_s, ev.prompt_len,
                                  ev.gen_len)
            # 2. admission: per-slot prefill, in-flight slots untouched
            for slot, req in mgr.fill():
                metrics.on_admit(req.rid, clock.now())
                first = self.runner.prefill(slot, req.prompt)
                clock.advance()
                n_prefills += 1
                if not req.out:         # restart replays deterministically
                    metrics.on_first_token(req.rid, clock.now())
                req.out.append(first)
                if len(req.out) >= req.gen_len:
                    req.done = True
            release(clock.now())
            # 3. one batched decode step for everything resident
            running = mgr.running()
            if running:
                last = np.zeros(mgr.n_slots, np.int32)
                for i, req in running:
                    last[i] = req.out[-1]
                nxt = self.runner.decode(last)
                clock.advance()
                n_decode_steps += 1
                for i, req in running:
                    req.out.append(int(nxt[i]))
                    if len(req.out) >= req.gen_len:
                        req.done = True
                release(clock.now())
            elif pending and not mgr.queue:
                clock.skip_to(pending[0].arrival_s)
            # 4. scenario-scheduled device loss at a global decode step
            if loss_at is not None and n_decode_steps >= loss_at:
                mgr = self._device_loss(mgr, metrics, loss_n, clock.now(),
                                        replans)
                loss_at = None
            # 5. sustained SLO violation -> autoscale
            if (self.autoscaler is not None and self.slo_check_every
                    and scenario is not None and n_decode_steps
                    and n_decode_steps % self.slo_check_every == 0):
                p99 = metrics.recent_p99_ttft(self.slo_window)
                if p99 == p99 and p99 > scenario.ttft_slo_s:  # nan-safe
                    slo_strikes += 1
                else:
                    slo_strikes = 0
                if slo_strikes >= self.slo_patience:
                    decision = self.autoscaler.on_slo_violation(
                        clock.now(), p99)
                    slo_strikes = 0
                    if decision is not None:
                        replans.append(decision)
                        mgr = self._rescale(mgr, metrics, decision)

        slo = (metrics.report(scenario.ttft_slo_s, scenario.tpot_slo_s)
               if scenario is not None else metrics.report())
        return EngineResult(streams=streams, metrics=metrics, slo=slo,
                            n_prefills=n_prefills,
                            n_decode_steps=n_decode_steps, replans=replans)
