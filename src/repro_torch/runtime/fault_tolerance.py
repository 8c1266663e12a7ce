"""Fault tolerance: checkpoint/restart supervision + straggler mitigation,
copied from the reference's ``repro/runtime/fault_tolerance.py``.  One
departure: ``TrainingSupervisor.run`` takes no ``restore_shardings``, as
the port's ``Checkpointer.restore`` places each leaf like the state it
restores into (``checkpoint/``).

``TrainingSupervisor`` wraps a step function with:
  * periodic async checkpointing (atomic — see checkpoint/),
  * automatic restart from the latest complete checkpoint on failure
    (including data-pipeline state, so no sample is skipped or repeated),
  * bounded retry with exponential backoff for transient failures.

``StragglerMonitor`` implements deadline-based straggler mitigation at the
step granularity: a step exceeding ``deadline_factor`` × the trailing
median is treated as straggling; the registered mitigation callback fires
(on a real cluster: re-dispatch the shard / hot-swap the replica — the
multi-controller hook is ``on_straggler``; on CPU CI it's observed-only).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Callable

from repro_torch.checkpoint import Checkpointer, latest_step

log = logging.getLogger(__name__)


@dataclasses.dataclass
class StragglerMonitor:
    deadline_factor: float = 3.0
    window: int = 32
    on_straggler: Callable[[int, float, float], None] | None = None
    _times: deque = dataclasses.field(default_factory=deque)
    straggler_steps: list[int] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        # honor the configured window (the deque default can't see it)
        self._times = deque(self._times, maxlen=self.window)

    def observe(self, step: int, duration_s: float) -> bool:
        is_straggler = False
        if len(self._times) >= 8:
            med = sorted(self._times)[len(self._times) // 2]
            if duration_s > self.deadline_factor * med:
                is_straggler = True
                self.straggler_steps.append(step)
                log.warning("step %d straggled: %.3fs vs median %.3fs",
                            step, duration_s, med)
                if self.on_straggler is not None:
                    self.on_straggler(step, duration_s, med)
        self._times.append(duration_s)
        return is_straggler


@dataclasses.dataclass
class TrainingSupervisor:
    checkpointer: Checkpointer
    checkpoint_every: int = 100
    max_retries: int = 3
    backoff_s: float = 0.1
    straggler: StragglerMonitor = dataclasses.field(
        default_factory=StragglerMonitor)
    # Exception types the retry/restart loop must NOT swallow: they
    # propagate to the caller immediately.  The degraded-mode runner passes
    # (DeviceLossFault,) here — a lost device cannot be retried away, it
    # needs a replan + recompile (runtime/degraded.py).
    fatal: tuple[type, ...] = ()

    def latest(self) -> int | None:
        return latest_step(self.checkpointer.directory)

    def run(
        self,
        state: Any,
        step_fn: Callable[[Any, Any], tuple[Any, dict]],
        batches: Any,                      # iterator with state()/restore()
        n_steps: int,
        start_step: int = 0,
    ) -> tuple[Any, list[dict]]:
        """Run n_steps with checkpoint/restart.  step_fn(state, batch) ->
        (state, metrics)."""
        # resume if a checkpoint exists
        last = self.latest()
        step = start_step
        if last is not None and last >= start_step:
            meta = self.checkpointer.meta(last)
            state = self.checkpointer.restore(last, state)
            if hasattr(batches, "restore") and "data_state" in meta:
                batches.restore(meta["data_state"])
            step = last + 1
            log.info("resumed from checkpoint step %d", last)

        history: list[dict] = []
        while step < start_step + n_steps:
            batch = next(batches)
            attempt = 0
            while True:
                try:
                    t0 = time.monotonic()
                    state, metrics = step_fn(state, batch)
                    dt = time.monotonic() - t0
                    break
                except Exception as e:                   # noqa: BLE001
                    if isinstance(e, self.fatal):
                        raise
                    attempt += 1
                    if attempt > self.max_retries:
                        # final fallback: restart from latest checkpoint
                        last = self.latest()
                        if last is None:
                            raise
                        log.exception(
                            "step %d failed %d times; restarting from %d",
                            step, attempt, last)
                        state = self.checkpointer.restore(last, state)
                        meta = self.checkpointer.meta(last)
                        if hasattr(batches, "restore") and "data_state" in meta:
                            batches.restore(meta["data_state"])
                        step = last + 1
                        batch = next(batches)
                        attempt = 0
                    time.sleep(self.backoff_s * (2 ** attempt))
            self.straggler.observe(step, dt)
            metrics = dict(metrics, step=step, seconds=dt)
            history.append(metrics)
            if self.checkpoint_every and (step + 1) % self.checkpoint_every == 0:
                extra = {}
                if hasattr(batches, "state"):
                    extra["data_state"] = batches.state()
                self.checkpointer.save(step, state, blocking=False,
                                       extra_meta=extra)
            step += 1
        self.checkpointer.wait()
        return state, history
