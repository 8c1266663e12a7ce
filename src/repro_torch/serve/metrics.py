"""Per-request latency accounting + SLO reporting for the serving engine,
copied whole from the reference ``repro/serve/metrics.py``.

One ``RequestRecord`` per request tracks the canonical serving
timestamps — arrival (from the trace), admission to a slot, first token
(TTFT ends here), completion — plus restart count (a request is restarted
from its prompt when a device loss or capacity change invalidates its KV
cache; greedy decode makes the replayed stream identical, so restarts
cost latency, never correctness).

``ServeMetrics`` enforces the lifecycle invariants the scheduler tests
pin: a request is submitted once, and finishes exactly once — double
submission or double finish raises instead of silently corrupting the
report.

``SLOReport`` field glossary (all times in seconds):

  p50_ttft_s / p99_ttft_s  time-to-first-token percentiles
                           (first token − arrival; includes queueing).
  p50_tpot_s / p99_tpot_s  time-per-output-token percentiles
                           ((finish − first token) / (n_gen − 1)).
  p50_e2e_s  / p99_e2e_s   end-to-end latency percentiles.
  throughput_tok_s         generated tokens / makespan (first arrival to
                           last completion).
  goodput_tok_s            same numerator restricted to requests that met
                           BOTH the TTFT and TPOT SLO targets — the
                           throughput that actually counted.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RequestRecord", "ServeMetrics", "SLOReport"]


@dataclasses.dataclass
class RequestRecord:
    rid: int
    arrival_s: float
    prompt_len: int
    gen_len: int
    admit_s: float | None = None
    first_token_s: float | None = None
    finish_s: float | None = None
    n_gen: int = 0
    restarts: int = 0

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> float | None:
        if self.finish_s is None or self.first_token_s is None:
            return None
        return ((self.finish_s - self.first_token_s)
                / max(self.n_gen - 1, 1))

    @property
    def e2e_s(self) -> float | None:
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s

    def meets(self, ttft_slo_s: float, tpot_slo_s: float) -> bool:
        return (self.finish_s is not None
                and self.ttft_s <= ttft_slo_s
                and self.tpot_s <= tpot_slo_s)


def _pct(vals: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(vals), q)) if vals else float("nan")


@dataclasses.dataclass(frozen=True)
class SLOReport:
    n_submitted: int
    n_finished: int
    n_restarts: int
    p50_ttft_s: float
    p99_ttft_s: float
    p50_tpot_s: float
    p99_tpot_s: float
    p50_e2e_s: float
    p99_e2e_s: float
    throughput_tok_s: float
    goodput_tok_s: float
    n_slo_ok: int
    makespan_s: float

    def to_row(self) -> dict:
        return dataclasses.asdict(self)


class ServeMetrics:
    """Collects RequestRecords as the engine runs; lifecycle-checked."""

    def __init__(self) -> None:
        self.records: dict[int, RequestRecord] = {}

    def on_submit(self, rid: int, arrival_s: float, prompt_len: int,
                  gen_len: int) -> None:
        if rid in self.records:
            raise RuntimeError(f"request {rid} submitted twice")
        self.records[rid] = RequestRecord(
            rid=rid, arrival_s=arrival_s, prompt_len=prompt_len,
            gen_len=gen_len)

    def _rec(self, rid: int) -> RequestRecord:
        try:
            return self.records[rid]
        except KeyError:
            raise RuntimeError(f"request {rid} was never submitted") from None

    def on_admit(self, rid: int, now: float) -> None:
        rec = self._rec(rid)
        if rec.admit_s is None:          # restarts keep the first admission
            rec.admit_s = now

    def on_first_token(self, rid: int, now: float) -> None:
        rec = self._rec(rid)
        if rec.first_token_s is None:    # restarts keep the first TTFT
            rec.first_token_s = now

    def on_restart(self, rid: int) -> None:
        self._rec(rid).restarts += 1

    def on_finish(self, rid: int, now: float, n_gen: int) -> None:
        rec = self._rec(rid)
        if rec.finish_s is not None:
            raise RuntimeError(f"request {rid} finished twice")
        rec.finish_s = now
        rec.n_gen = n_gen

    @property
    def finished(self) -> list[RequestRecord]:
        return [r for r in self.records.values() if r.finish_s is not None]

    def report(self, ttft_slo_s: float = float("inf"),
               tpot_slo_s: float = float("inf")) -> SLOReport:
        done = self.finished
        ttft = [r.ttft_s for r in done]
        tpot = [r.tpot_s for r in done]
        e2e = [r.e2e_s for r in done]
        if done:
            makespan = (max(r.finish_s for r in done)
                        - min(r.arrival_s for r in done))
        else:
            makespan = 0.0
        denom = max(makespan, 1e-9)
        ok = [r for r in done if r.meets(ttft_slo_s, tpot_slo_s)]
        return SLOReport(
            n_submitted=len(self.records),
            n_finished=len(done),
            n_restarts=sum(r.restarts for r in self.records.values()),
            p50_ttft_s=_pct(ttft, 50), p99_ttft_s=_pct(ttft, 99),
            p50_tpot_s=_pct(tpot, 50), p99_tpot_s=_pct(tpot, 99),
            p50_e2e_s=_pct(e2e, 50), p99_e2e_s=_pct(e2e, 99),
            throughput_tok_s=sum(r.n_gen for r in done) / denom,
            goodput_tok_s=sum(r.n_gen for r in ok) / denom,
            n_slo_ok=len(ok),
            makespan_s=makespan,
        )

    def recent_p99_ttft(self, window: int = 8) -> float:
        """p99 TTFT over the most recently *finished* requests — the
        autoscaler's sustained-violation signal."""
        done = sorted(self.finished, key=lambda r: r.finish_s)[-window:]
        return _pct([r.ttft_s for r in done], 99)
