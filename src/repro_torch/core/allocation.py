"""Core allocation on the ONoC ring — the paper's Section 4.

Copied from the reference ``repro/core/allocation.py``, unchanged.

Three mapping strategies place the m_i* cores of each period on the ring:

  FM   (Fixed Mapping):           period i gets cores [1 .. m_i*]
  RRM  (Round-Robin Mapping):     period i starts after period i-1's last core
  ORRM (Overlapped Round-Robin):  RRM but reusing r_i cores between adjacent
                                  periods (Algorithm 1, Eqs. 16-18)

A mapping is represented two ways:
  * ``windows``: per FP period, the ordered list of ring core ids (0-based),
  * ``M``: the paper's mapping matrix — M[i][j] = core id of the j-th neuron
    of layer i (a dict of arrays; the paper's 0/1 tensor M(i,j,k) is sparse
    one-hot over k, we store the argmax).

BP periods reuse the FP windows via the data-locality constraint (Eq. 11).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np

from .onoc_model import FCNNWorkload, ONoCConfig, optimal_cores

__all__ = [
    "MappingStrategy",
    "Mapping",
    "expected_reuse",
    "reuse_counts",
    "map_cores",
    "neuron_assignment",
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

    def neuron_core(self, layer: int, j: int) -> int:
        """Core id of neuron j (0-based) of layer ``layer`` (1-based)."""
        w = self.windows[layer - 1]
        return w[j % len(w)]

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
        # FM's reuse between adjacent periods is min(m_i, m_{i+1}) by
        # construction; the ``reuse`` field reports the ORRM-style r_i
        # (planned extra reuse), which FM does not use.
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


def neuron_assignment(workload: FCNNWorkload, mapping: Mapping) -> dict[int, np.ndarray]:
    """The paper's mapping matrix M, densified: layer -> array of core ids.

    Neurons are mapped evenly: neuron j of layer i goes to window[j mod m_i]
    (Algorithm 1 lines 3 & 8 distribute evenly; round-robin over the window
    yields |count_k - count_k'| <= 1 for all cores k, k' in the window).
    """
    out: dict[int, np.ndarray] = {}
    for layer in range(1, workload.l + 1):
        w = np.asarray(mapping.windows[layer - 1], dtype=np.int64)
        n_i = workload.n(layer)
        out[layer] = w[np.arange(n_i) % len(w)]
    return out
