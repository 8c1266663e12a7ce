"""Deterministic open-loop traffic for the serving subsystem, copied
whole from the reference ``repro/serve/traffic.py`` (numpy only), so the
same (scenario, seed) gives the port the same trace bit for bit.

A ``TrafficTrace`` is seeded, replayable data in the style of
``runtime.faults.FaultSchedule``: the same ``(scenario, seed)`` pair
produces the same arrival/length event list every run, on every machine,
independent of how many slots or devices the serving engine happens to
have.  Arrivals are open-loop (Poisson, optionally with a burst window),
so a slow server builds a queue instead of slowing the offered load —
the millions-of-users regime, shrunk to a replayable event list.

Prompt/generation lengths are Zipf-distributed over *bucket lists* rather
than free integers: the engine compiles one batch-1 prefill per distinct
prompt length, so lengths must come from a small fixed set (the standard
XLA serving shape-bucket pattern).  Prompt token *content* is derived
per-request from ``(trace seed, rid)`` via ``prompt_tokens`` — also
independent of scheduling, so a request's greedy decode stream is a pure
function of the trace, never of batching, slot placement, or faults.

Scenario presets (``scenario_preset``):

  steady                  Poisson arrivals at a constant rate.
  burst                   low base rate with a windowed multiplier —
                          the queue spikes, then drains.
  drain                   the whole request set arrives almost at once,
                          then arrivals stop while the slots drain.
  device-loss-mid-decode  steady arrivals plus a device-loss event fired
                          at a fixed global decode step (the serving
                          analogue of FaultSchedule.seeded_device_loss).
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

__all__ = [
    "Scenario",
    "RequestEvent",
    "TrafficTrace",
    "SCENARIO_NAMES",
    "scenario_preset",
    "make_traffic",
    "prompt_tokens",
]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named traffic shape + the SLO targets it is judged against.

    ``burst``       (t0_s, t1_s, multiplier): arrival rate is
                    ``rate_rps * multiplier`` inside [t0, t1).
    ``device_loss`` (at_decode_step, n_lost): the engine fires a
                    device-loss event when its global decode-step counter
                    reaches ``at_decode_step``.
    Length buckets are the only lengths the generator emits; Zipf rank 1
    is the *first* bucket, so order buckets most-common-first if you want
    short prompts to dominate.
    """

    name: str
    n_requests: int = 16
    rate_rps: float = 50.0
    burst: tuple[float, float, float] | None = None
    device_loss: tuple[int, int] | None = None
    prompt_buckets: tuple[int, ...] = (8, 16, 32)
    gen_buckets: tuple[int, ...] = (4, 8, 16)
    zipf_a: float = 1.2
    ttft_slo_s: float = 0.5
    tpot_slo_s: float = 0.1

    def __post_init__(self) -> None:
        if self.n_requests < 1:
            raise ValueError("n_requests >= 1")
        if self.rate_rps <= 0:
            raise ValueError("rate_rps > 0")
        for b in (*self.prompt_buckets, *self.gen_buckets):
            if b < 1:
                raise ValueError(f"length buckets must be >= 1, got {b}")

    @property
    def max_len(self) -> int:
        """Deepest sequence any request of this scenario can reach."""
        return max(self.prompt_buckets) + max(self.gen_buckets)

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


_PRESETS: dict[str, Scenario] = {
    "steady": Scenario("steady"),
    "burst": Scenario("burst", n_requests=24, rate_rps=20.0,
                      burst=(0.2, 0.5, 10.0)),
    "drain": Scenario("drain", n_requests=24, rate_rps=2000.0),
    "device-loss-mid-decode": Scenario(
        "device-loss-mid-decode", device_loss=(4, 2)),
}

SCENARIO_NAMES: tuple[str, ...] = tuple(_PRESETS)


def scenario_preset(name: str, **overrides) -> Scenario:
    """A named preset, optionally with fields overridden (bucket lists,
    request counts, rates — anything but the name)."""
    if name not in _PRESETS:
        raise KeyError(
            f"unknown scenario {name!r}; presets: {', '.join(_PRESETS)}")
    sc = _PRESETS[name]
    return sc.replace(**overrides) if overrides else sc


@dataclasses.dataclass(frozen=True)
class RequestEvent:
    """One request of a trace: arrival time + shape, no token content
    (content is derived on demand by ``prompt_tokens`` so the trace stays
    model/vocab independent)."""

    rid: int
    arrival_s: float
    prompt_len: int
    gen_len: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class TrafficTrace:
    """A replayable, seed-deterministic request list (arrival-sorted)."""

    events: tuple[RequestEvent, ...]
    seed: int
    scenario: str

    def __len__(self) -> int:
        return len(self.events)

    @property
    def rids(self) -> tuple[int, ...]:
        return tuple(e.rid for e in self.events)

    @property
    def duration_s(self) -> float:
        return self.events[-1].arrival_s if self.events else 0.0

    def to_dicts(self) -> list[dict]:
        return [e.to_dict() for e in self.events]


def _zipf_pick(rng: np.random.Generator, buckets: tuple[int, ...],
               a: float) -> int:
    """Zipf over bucket *ranks*: P(bucket k) ∝ 1 / (k+1)^a."""
    p = 1.0 / np.arange(1, len(buckets) + 1, dtype=np.float64) ** a
    p /= p.sum()
    return int(buckets[rng.choice(len(buckets), p=p)])


def _rate_at(sc: Scenario, t: float) -> float:
    if sc.burst is not None:
        t0, t1, mult = sc.burst
        if t0 <= t < t1:
            return sc.rate_rps * mult
    return sc.rate_rps


def make_traffic(sc: Scenario, seed: int) -> TrafficTrace:
    """Generate the scenario's replayable event list.

    The RNG is seeded from ``(seed, crc32(scenario name))`` so two
    scenarios with coincidentally equal parameters still get distinct
    traces, while the same (scenario, seed) is bit-identical across runs.
    Nothing here depends on slot count, device count, or the model.
    """
    rng = np.random.default_rng([seed, zlib.crc32(sc.name.encode())])
    events: list[RequestEvent] = []
    t = 0.0
    for rid in range(sc.n_requests):
        t += float(rng.exponential(1.0 / _rate_at(sc, t)))
        events.append(RequestEvent(
            rid=rid,
            arrival_s=t,
            prompt_len=_zipf_pick(rng, sc.prompt_buckets, sc.zipf_a),
            gen_len=_zipf_pick(rng, sc.gen_buckets, sc.zipf_a),
        ))
    return TrafficTrace(events=tuple(events), seed=seed, scenario=sc.name)


def prompt_tokens(seed: int, event: RequestEvent, vocab: int) -> np.ndarray:
    """Deterministic prompt content for one request: a pure function of
    (trace seed, rid, vocab), independent of scheduling order."""
    if vocab < 1:
        raise ValueError("vocab >= 1")
    rng = np.random.default_rng([seed, event.rid, 1_000_003])
    return rng.integers(0, vocab, size=event.prompt_len,
                        dtype=np.int64).astype(np.int32)
