"""Per-device parameter-residency accounting for compiled programs, copied
from the reference ``repro/exec/residency.py``.

Turns a schema-v2 ``PeriodProgram``'s residency annotations (``param_bytes``
on RUN, param FREEs at each layer's BP mirror period) into a per-device
live-bytes timeline, so tests and benchmarks can assert the tentpole claim
of the weight-sharded executor: per-device peak live parameter bytes scale
as ~1/d versus the replicated oracle, and FREE instructions *release*
residency at exactly the scheduled periods.

Two modes mirror the two executor paths (see exec/runtime.py):

  * ``"sharded"``  — at step start each device acquires the column chunks
    of every layer whose FP window contains it (``param_bytes`` per layer);
    a param FREE at the layer's BP mirror period 2l-i+1 (Eq. 11, the
    chunk's last use) subtracts those bytes.  The ledger must drain to
    exactly zero by period 2l.
  * ``"replicated"`` — the oracle: every device holds the full model
    for the whole epoch; FREE is a cost annotation, nothing is released.

The tracker is pure accounting over program annotations — it does not
execute anything.  ``exec.validate`` separately checks the annotations
themselves are consistent (bytes match geometry, FREEs sit at the mirror
periods, no RUN touches freed chunks).
"""

from __future__ import annotations

import dataclasses

from repro_torch.exec.program import PeriodProgram

__all__ = ["ResidencySnapshot", "ResidencyTracker", "replicated_model_bytes"]


def replicated_model_bytes(program: PeriodProgram) -> float:
    """Full-model parameter bytes one device holds under replication.

    Recovered from the program's own annotations: a layer's full weight
    matrix is ``degree`` column chunks of ``param_bytes`` each.
    """
    return float(sum(r.param_bytes * r.degree for r in program.runs("fp")))


@dataclasses.dataclass(frozen=True)
class ResidencySnapshot:
    """Live parameter bytes per device *after* ``period``'s instructions.

    ``period == 0`` is the acquisition snapshot: chunks placed at step
    start, before any instruction runs.
    """

    period: int
    live_bytes: tuple[float, ...]

    @property
    def peak(self) -> float:
        return max(self.live_bytes)


class ResidencyTracker:
    """Walk a program's residency annotations into per-device timelines."""

    def __init__(self, program: PeriodProgram, mode: str = "sharded"):
        if mode not in ("sharded", "replicated"):
            raise ValueError(f"mode must be 'sharded' or 'replicated', "
                             f"got {mode!r}")
        if mode == "sharded" and program.version < 2:
            raise ValueError(
                f"program schema v{program.version} has no residency "
                f"annotations; recompile with compile_program for sharded "
                f"residency tracking")
        self.program = program
        self.mode = mode
        self.n_devices = program.n_devices
        self._snapshots = self._walk()

    # ------------------------------------------------------------- walking

    def _acquire(self) -> list[float]:
        live = [0.0] * self.n_devices
        if self.mode == "replicated":
            full = replicated_model_bytes(self.program)
            return [full] * self.n_devices
        for run in self.program.runs("fp"):
            for dev in run.devices:
                live[dev] += run.param_bytes
        return live

    def _walk(self) -> list[ResidencySnapshot]:
        live = self._acquire()
        snaps = [ResidencySnapshot(0, tuple(live))]
        n_periods = 2 * self.program.l
        by_period: dict[int, list] = {p: [] for p in range(1, n_periods + 1)}
        for f in self.program.frees("param"):
            by_period[f.period].append(f)
        for p in range(1, n_periods + 1):
            if self.mode == "sharded":
                for f in by_period[p]:
                    for dev in f.devices:
                        live[dev] -= f.param_bytes
            snaps.append(ResidencySnapshot(p, tuple(live)))
        return snaps

    # ------------------------------------------------------------- queries

    def timeline(self) -> list[ResidencySnapshot]:
        """Snapshots at period 0 (acquisition) and after each period."""
        return list(self._snapshots)

    def live_at(self, period: int) -> tuple[float, ...]:
        """Per-device bytes live *while* ``period`` executes — i.e. after
        the frees of all earlier periods (period p sees snapshot p-1)."""
        if not 1 <= period <= 2 * self.program.l:
            raise ValueError(f"period out of range: {period}")
        return self._snapshots[period - 1].live_bytes

    def peak_bytes(self) -> tuple[float, ...]:
        """Per-device peak live parameter bytes over the epoch."""
        return tuple(
            max(s.live_bytes[d] for s in self._snapshots)
            for d in range(self.n_devices)
        )

    def final_bytes(self) -> tuple[float, ...]:
        """Per-device bytes after period 2l — zero iff the ledger drains."""
        return self._snapshots[-1].live_bytes

    def release_periods(self) -> list[int]:
        """Periods at which any device's live bytes strictly decreased."""
        out = []
        for prev, cur in zip(self._snapshots, self._snapshots[1:]):
            if any(c < p for p, c in zip(prev.live_bytes, cur.live_bytes)):
                out.append(cur.period)
        return out

    def peak_ratio(self) -> float:
        """max-device sharded peak / replicated full-model bytes (<= 1;
        equals 1/d on a uniform-degree ring)."""
        full = replicated_model_bytes(self.program)
        if self.mode == "replicated":
            return 1.0
        return max(self.peak_bytes()) / full if full else 0.0
