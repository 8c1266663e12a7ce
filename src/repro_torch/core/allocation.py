"""Core allocation on the ONoC ring (the paper's Section 4), copied from
the reference ``repro/core/allocation.py`` and cut to the mapping that
``plan_fcnn`` builds and the period windows the simulator and the program
compiler read.

  FM   (Fixed Mapping):           period i gets cores [1 .. m_i*]
  RRM  (Round-Robin Mapping):     period i starts after period i-1's last core
  ORRM (Overlapped Round-Robin):  RRM but reusing r_i cores between adjacent
                                  periods (Algorithm 1, Eqs. 16-18)

BP periods reuse the FP windows via the data-locality constraint (Eq. 11).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

from .onoc_model import FCNNWorkload, ONoCConfig, optimal_cores

__all__ = [
    "MappingStrategy",
    "Mapping",
    "expected_reuse",
    "reuse_counts",
    "map_cores",
]


class MappingStrategy(str, enum.Enum):
    FM = "fm"
    RRM = "rrm"
    ORRM = "orrm"


@dataclasses.dataclass(frozen=True)
class Mapping:
    """A complete neuron→core placement for one epoch."""

    strategy: MappingStrategy
    m: int                                  # ring size
    cores_per_period: tuple[int, ...]       # m_i* for FP periods 1..l
    windows: tuple[tuple[int, ...], ...]    # per FP period, ring core ids
    reuse: tuple[int, ...]                  # r_i per FP period (r_1 = 0)

    @property
    def l(self) -> int:  # noqa: E743
        return len(self.windows)

    def window(self, period: int) -> tuple[int, ...]:
        """Ring core ids for any period 1..2l (Eq. 11 ties BP to FP)."""
        l = self.l
        if 1 <= period <= l:
            return self.windows[period - 1]
        if l + 1 <= period <= 2 * l:
            return self.windows[2 * l - period]
        raise ValueError(f"period out of range: {period}")

    def active_cores(self) -> set[int]:
        out: set[int] = set()
        for w in self.windows:
            out.update(w)
        return out


def expected_reuse(cores_per_period: Sequence[int], m: int) -> float:
    """E[r], Eq. (16)."""
    l = len(cores_per_period)
    total = sum(cores_per_period)
    if total <= m or l <= 1:
        return 0.0
    return (total - m) / (l - 1)


def reuse_counts(cores_per_period: Sequence[int], m: int) -> list[int]:
    """r_i, Eq. (17):  r_1 = 0;
    r_i = min(round(E[r]), m_{i-1}* - r_{i-1}, m_i*)  for i in [2, l]."""
    e_r = expected_reuse(cores_per_period, m)
    r = [0]
    for i in range(1, len(cores_per_period)):
        r_i = min(
            int(round(e_r)),
            cores_per_period[i - 1] - r[i - 1],
            cores_per_period[i],
        )
        r.append(max(0, r_i))
    return r


def map_cores(
    workload: FCNNWorkload,
    cfg: ONoCConfig,
    strategy: MappingStrategy | str = MappingStrategy.ORRM,
    cores_per_period: Sequence[int] | None = None,
) -> Mapping:
    """Place the per-period core counts on the ring (paper Section 4.1).

    ``cores_per_period`` defaults to the Lemma-1 optimum.
    """
    strategy = MappingStrategy(strategy)
    if cores_per_period is None:
        cores_per_period = optimal_cores(workload, cfg)
    cores_per_period = [int(c) for c in cores_per_period]
    l = workload.l
    if len(cores_per_period) != l:
        raise ValueError(f"need {l} core counts, got {len(cores_per_period)}")
    if max(cores_per_period) > cfg.m:
        raise ValueError("a period requests more cores than the ring has")

    m = cfg.m
    windows: list[tuple[int, ...]] = []

    if strategy is MappingStrategy.FM:
        reuse = [0] * l
        for m_i in cores_per_period:
            windows.append(tuple(range(m_i)))
    elif strategy is MappingStrategy.RRM:
        reuse = [0] * l
        nxt = 0
        for m_i in cores_per_period:
            windows.append(tuple((nxt + k) % m for k in range(m_i)))
            nxt = (nxt + m_i) % m
    else:  # ORRM, Algorithm 1
        reuse = reuse_counts(cores_per_period, m)
        start = 0  # id_1 = 1 in the paper's 1-based indexing
        for i, m_i in enumerate(cores_per_period):
            if i > 0:
                # id_i = id_{i-1} + (m_{i-1}* - r_i)   (Eq. 18, telescoped)
                start = (start + cores_per_period[i - 1] - reuse[i]) % m
            windows.append(tuple((start + k) % m for k in range(m_i)))

    return Mapping(
        strategy=strategy,
        m=m,
        cores_per_period=tuple(cores_per_period),
        windows=tuple(windows),
        reuse=tuple(reuse),
    )
