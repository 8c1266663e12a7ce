"""Epoch-time simulator for FCNN training on ONoC and ENoC — the paper's
Gem5 stand-in (Section 5.1) — copied from the reference
``repro/core/simulator.py``.  The reference's per-pair loop
``ENoCBackend.transition_time_reference``, an oracle of its own tests, is
not copied.

Two interconnect backends:

  * ``ONoCBackend``  — WDM/TDM ring (Section 3.1.2): per transition,
    ceil(senders/λ)·B time slots; latency is distance-independent (one
    time-of-flight regardless of hop count), which is why the paper finds
    FM ≈ RRM ≈ ORRM on ONoC.
  * ``ENoCBackend``  — electrical 2-D mesh with XY shortest-path routing,
    2-cycle per-hop routers (Section 5.4), no multicast: a broadcast is a
    sequence of unicasts.  Per transition the time is the max over links of
    serialized traffic plus the average path latency — distance (and hence
    the mapping strategy) matters.

The simulator consumes a Mapping (strategy-placed windows), so all of the
paper's §4 placement effects are visible to the ENoC backend, and the
traffic/occupancy traces feed the energy model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Protocol

import numpy as np

from .allocation import Mapping, MappingStrategy, map_cores
from .onoc_model import (
    FCNNWorkload,
    ONoCConfig,
    compute_time,
    comm_time,
    period_layer,
    slot_time,
)

__all__ = [
    "TransitionTraffic",
    "EpochTrace",
    "ONoCBackend",
    "ENoCConfig",
    "ENoCBackend",
    "simulate_epoch",
]


@dataclasses.dataclass(frozen=True)
class TransitionTraffic:
    """Data movement out of one period into the next."""

    period: int
    senders: tuple[int, ...]
    receivers: tuple[int, ...]
    bytes_per_sender: float
    comm_s: float                  # backend-computed transition time
    hop_bytes: float = 0.0         # Σ bytes × hops (ENoC); 0 for ONoC
    slots: int = 0                 # TDM slots (ONoC); 0 for ENoC


@dataclasses.dataclass(frozen=True)
class EpochTrace:
    backend: str
    strategy: str
    compute_s: float
    comm_s: float
    transitions: tuple[TransitionTraffic, ...]
    per_period_compute_s: tuple[float, ...]
    core_busy_s: np.ndarray        # per-core active seconds (compute)

    @property
    def total_s(self) -> float:
        return self.compute_s + self.comm_s

    @property
    def total_bytes(self) -> float:
        return float(
            sum(t.bytes_per_sender * len(t.senders) for t in self.transitions)
        )

    @property
    def total_hop_bytes(self) -> float:
        return float(sum(t.hop_bytes for t in self.transitions))


class _Backend(Protocol):
    name: str

    def transition_time(
        self,
        workload: FCNNWorkload,
        cfg: ONoCConfig,
        period: int,
        mapping: Mapping,
    ) -> TransitionTraffic: ...


def _transition_payload_bytes(
    workload: FCNNWorkload, cfg: ONoCConfig, period: int, m_i: int
) -> float:
    """Bytes each sender core pushes out of ``period``."""
    x_i = math.ceil(workload.n(period_layer(workload, period)) / m_i)
    return x_i * workload.batch_size * cfg.bytes_per_value


class ONoCBackend:
    """WDM/TDM ring — Eq. (6) exactly."""

    name = "onoc"

    def transition_time(
        self,
        workload: FCNNWorkload,
        cfg: ONoCConfig,
        period: int,
        mapping: Mapping,
    ) -> TransitionTraffic:
        senders = mapping.window(period)
        receivers = mapping.window(period + 1)
        m_i = len(senders)
        payload = _transition_payload_bytes(workload, cfg, period, m_i)
        slots = math.ceil(m_i / cfg.lambda_max)
        t = comm_time(workload, cfg, period, m_i)
        return TransitionTraffic(
            period=period, senders=senders, receivers=receivers,
            bytes_per_sender=payload, comm_s=t, slots=slots,
        )


@dataclasses.dataclass(frozen=True)
class ENoCConfig:
    """Electrical 2-D mesh parameters (paper Section 5.4 + Table 4/5)."""

    hop_cycles: float = 2.0          # per-hop router latency
    link_bytes_per_cycle: float = 16.0  # 128-bit links, 1 flit/cycle
    clock_hz: float = 3.4e9
    channels: int = 4                # 4-channel routers (paper §5.4)

    def link_bandwidth_Bps(self) -> float:
        """Per-channel serialization bandwidth of one directed link."""
        return self.link_bytes_per_cycle * self.clock_hz

    def effective_link_bandwidth_Bps(self) -> float:
        """Drain bandwidth of one directed link: the router's ``channels``
        parallel channels each serialize at ``link_bandwidth_Bps`` (this is
        how the 4-channel routers of §5.4 enter the traffic model).

        Deliberately ENoC-optimistic: real router channels are virtual
        channels sharing one physical link, so crediting them as parallel
        serializers gives ENoC up to ``channels``× the paper's effective
        bandwidth.  The ONoC-vs-ENoC comparisons therefore UNDER-state the
        paper's gaps (Fig. 10 time reduction ~4% here vs 13-21% in the
        paper) — every "ONoC wins" result holds even with this head start.
        Set ``channels=1`` to recover the single-serializer model."""
        return self.link_bandwidth_Bps() * self.channels


class ENoCBackend:
    """2-D mesh, XY shortest-path, unicast-only broadcast."""

    name = "enoc"

    def __init__(self, enoc: ENoCConfig | None = None):
        self.enoc = enoc or ENoCConfig()

    def _grid(self, m: int) -> int:
        return max(1, int(math.ceil(math.sqrt(m))))

    def _xy(self, core: int, side: int) -> tuple[int, int]:
        return core % side, core // side

    def _hops(self, a: int, b: int, side: int) -> int:
        ax, ay = self._xy(a, side)
        bx, by = self._xy(b, side)
        return abs(ax - bx) + abs(ay - by)

    def transition_time(
        self,
        workload: FCNNWorkload,
        cfg: ONoCConfig,
        period: int,
        mapping: Mapping,
    ) -> TransitionTraffic:
        """Vectorized XY link-load accumulation.

        Each sender unicasts its payload to every receiver (no multicast).
        Traffic model: per-link serialized occupancy with XY routing; the
        transition completes when the most-loaded link drains at the
        router's aggregate channel bandwidth (``channels`` parallel
        channels per link, §5.4), plus one max-path latency to account
        for the pipeline fill.

        A pair (s, r) traverses the eastbound link (x, y)->(x+1, y) iff
        s is in row y with sx <= x and rx >= x+1 (X-first routing), and the
        northbound link (c, y)->(c, y+1) iff rx == c with ry >= y+1 and
        sy <= y — sender/receiver conditions are independent, so every
        directed link's pair count is a product of two cumulative counts.
        That turns the O(m_i² · hops) Python loop into O(side²) numpy.
        Self-pairs (r == s) can satisfy none of the segment conditions and
        traverse zero hops, so no exclusion term is needed.  Link loads and
        hop_bytes are integer-valued, so count × payload is bit-identical
        to the loop's repeated addition.
        """
        senders = mapping.window(period)
        receivers = mapping.window(period + 1)
        m_i = len(senders)
        payload = _transition_payload_bytes(workload, cfg, period, m_i)
        side = self._grid(mapping.m)

        s = np.asarray(senders, dtype=np.int64)
        r = np.asarray(receivers, dtype=np.int64)
        sx, sy = s % side, s // side
        rx, ry = r % side, r // side

        hops = np.abs(sx[:, None] - rx[None, :]) + np.abs(
            sy[:, None] - ry[None, :])
        hop_bytes = payload * float(hops.sum())
        max_hops = int(hops.max()) if hops.size else 0

        # per-cell occupancy counts
        s_grid = np.zeros((side, side), dtype=np.int64)   # [y, x] senders
        np.add.at(s_grid, (sy, sx), 1)
        r_grid = np.zeros((side, side), dtype=np.int64)   # [x, y] receivers
        np.add.at(r_grid, (rx, ry), 1)
        s_per_row = s_grid.sum(axis=1)                    # [y]
        r_per_col = r_grid.sum(axis=1)                    # [x]

        max_pairs = 0
        if side > 1:
            # horizontal links in row y at x (east: x->x+1, west: x+1->x)
            s_le_x = np.cumsum(s_grid, axis=1)            # sx <= x in row y
            s_ge_x = s_grid[:, ::-1].cumsum(axis=1)[:, ::-1]
            r_le_c = np.cumsum(r_per_col)                 # rx <= x (any row)
            r_ge_c = r_per_col[::-1].cumsum()[::-1]
            east = s_le_x[:, :-1] * r_ge_c[None, 1:]
            west = s_ge_x[:, 1:] * r_le_c[None, :-1]
            # vertical links in column c at y (north: y->y+1, south: y+1->y)
            r_le_y = np.cumsum(r_grid, axis=1)            # rx==c, ry <= y
            r_ge_y = r_grid[:, ::-1].cumsum(axis=1)[:, ::-1]
            s_le_row = np.cumsum(s_per_row)               # sy <= y (any col)
            s_ge_row = s_per_row[::-1].cumsum()[::-1]
            north = r_ge_y[:, 1:] * s_le_row[None, :-1]
            south = r_le_y[:, :-1] * s_ge_row[None, 1:]
            max_pairs = max(int(east.max()), int(west.max()),
                            int(north.max()), int(south.max()))

        bw = self.enoc.effective_link_bandwidth_Bps()
        drain = (max_pairs * payload / bw) if max_pairs else 0.0
        latency = max_hops * self.enoc.hop_cycles / self.enoc.clock_hz
        return TransitionTraffic(
            period=period, senders=senders, receivers=receivers,
            bytes_per_sender=payload, comm_s=drain + latency,
            hop_bytes=hop_bytes,
        )


def simulate_epoch(
    workload: FCNNWorkload,
    cfg: ONoCConfig,
    mapping: Mapping | None = None,
    strategy: MappingStrategy | str = MappingStrategy.FM,
    cores_per_period: list[int] | None = None,
    backend: _Backend | None = None,
    faults=None,
) -> EpochTrace:
    """Simulate one epoch: per-period compute + per-transition comm.

    Communication transitions follow Eq. (6)'s convention: there are
    exactly 2l−2 of them, at periods i ∈ {1, …, 2l−1} \\ {l}.  Period l
    (the forward→backward turnaround at the output layer) keeps its data
    in place, and period 2l ends the epoch, so neither sends.  On ONoC,
    period 1's hand-off is additionally charged as zero time — Eq. (6)
    sets g(m_1) = 0, folding it into Period-0 input loading — though its
    traffic is still recorded; on ENoC nothing is free and period 1 pays
    like every other transition.

    ``faults`` (optional) is a degradation model, typically
    ``runtime.faults.EpochFaults``, with three hooks:
    ``apply_config(cfg)`` (wavelength loss shrinks the usable comb),
    ``compute_scale(period)`` (straggling cores inflate compute), and
    ``apply_transition(traffic, period)`` (degraded links inflate drain).
    Degradation never changes *what* is scheduled, only its price; the
    ONoC period-1 free hand-off stays free (Eq. 6 is a scheduling
    convention, not a bandwidth property).
    """
    backend = backend or ONoCBackend()
    if faults is not None:
        cfg = faults.apply_config(cfg)
    if mapping is None:
        mapping = map_cores(workload, cfg, strategy, cores_per_period)
    l = workload.l

    per_period_compute: list[float] = []
    busy = np.zeros(mapping.m, dtype=np.float64)
    for i in range(1, 2 * l + 1):
        m_i = len(mapping.window(i))
        f = compute_time(workload, cfg, i, m_i)
        if faults is not None:
            f *= faults.compute_scale(i)
        per_period_compute.append(f)
        busy[list(mapping.window(i))] += f

    transitions: list[TransitionTraffic] = []
    comm_total = 0.0
    for i in range(1, 2 * l):   # period 2l is excluded by the range itself
        if i == l:
            continue
        tr = backend.transition_time(workload, cfg, i, mapping)
        if faults is not None:
            tr = faults.apply_transition(tr, i)
        if backend.name == "onoc" and i == 1:
            # Eq. (6): g(m_1) = 0 — the ONoC model folds the period-1
            # hand-off into Period 0 loading.  Record traffic, zero time.
            tr = dataclasses.replace(tr, comm_s=0.0)
        transitions.append(tr)
        comm_total += tr.comm_s

    return EpochTrace(
        backend=backend.name,
        strategy=mapping.strategy.value,
        compute_s=float(sum(per_period_compute)),
        comm_s=float(comm_total),
        transitions=tuple(transitions),
        per_period_compute_s=tuple(per_period_compute),
        core_busy_s=busy,
    )
