"""Mapping-strategy analyses — paper Sections 4.2–4.5.

Copied from the reference ``repro/core/analyses.py``, unchanged.

  Theorem 2  max consecutive active periods (hotspot level)
  Table 1    state-transition counts per epoch
  Table 2    maximum routing-path length (crosstalk / insertion loss proxy)
  Eq. (19)   insertion loss of a routing path
  Eq. (20) / Table 3   per-core SRAM requirement
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .allocation import Mapping, MappingStrategy, neuron_assignment
from .onoc_model import FCNNWorkload

__all__ = [
    "hotspot_consecutive_periods",
    "state_transitions",
    "max_path_length",
    "insertion_loss_db",
    "OpticalLossParams",
    "memory_per_core_bytes",
    "max_memory_requirement_bytes",
    "StrategyReport",
    "analyze_mapping",
]


def hotspot_consecutive_periods(mapping: Mapping) -> int:
    """Maximum number of consecutive periods any core is active in one epoch
    (FP periods 1..l then BP periods l+1..2l = FP windows reversed) —
    the paper's hotspot metric (Theorem 2)."""
    l = mapping.l
    seq = [set(mapping.window(p)) for p in range(1, 2 * l + 1)]
    best = 0
    cores = set().union(*seq) if seq else set()
    for c in cores:
        run = 0
        for s in seq:
            run = run + 1 if c in s else 0
            best = max(best, run)
    return best


def state_transitions(mapping: Mapping) -> int:
    """Number of active<->idle transitions over one epoch, counted per core
    (2 per activation burst: one wake, one sleep) — Table 1's quantity,
    computed exactly from the placement rather than the closed forms."""
    l = mapping.l
    seq = [set(mapping.window(p)) for p in range(1, 2 * l + 1)]
    cores = set().union(*seq) if seq else set()
    transitions = 0
    for c in cores:
        active = [c in s for s in seq]
        bursts = 0
        prev = False
        for a in active:
            if a and not prev:
                bursts += 1
            prev = a
        transitions += 2 * bursts
    return transitions


def state_transitions_closed_form(mapping: Mapping) -> int:
    """Table 1's closed forms (for cross-checking against the exact count)."""
    ms = mapping.cores_per_period
    l = len(ms)
    if mapping.strategy is MappingStrategy.FM:
        return 2 * (ms[0] + sum(abs(ms[i] - ms[i - 1]) for i in range(1, l)))
    # For RRM/ORRM the paper's expressions cover the FP+BP epoch:
    #   RRM : 2(sum_{i=1..2l} m_i* - m_l*)          [period l and l+1 share cores]
    #   ORRM: 2(sum_{i=1..2l} m_i* - m_l* - sum r_i)
    total_2l = 2 * sum(ms)  # BP mirrors FP (Eq. 11)
    if mapping.strategy is MappingStrategy.RRM:
        return 2 * (total_2l - ms[-1])
    # ORRM: reuse happens between FP-adjacent, BP-adjacent and the FP->BP turn
    r = mapping.reuse
    return 2 * (total_2l - ms[-1] - 2 * sum(r))


def max_path_length(mapping: Mapping) -> int:
    """Table 2: the maximum routing-path length (in ring hops) over all
    period transitions.  A broadcast from period i's window to period i+1's
    window travels from the first sender to the farthest receiver."""
    l = mapping.l
    best = 0
    for i in range(1, 2 * l):  # transitions between consecutive periods
        senders = mapping.window(i)
        receivers = mapping.window(i + 1)
        if not senders or not receivers:
            continue
        # Path runs along the ring from each sender to the farthest receiver
        # in the transmission direction (clockwise in FP, counter-clockwise
        # in BP — symmetric on a ring, so use clockwise distance).
        for s in senders:
            far = max((r - s) % mapping.m for r in receivers)
            best = max(best, far)
    return best


@dataclasses.dataclass(frozen=True)
class OpticalLossParams:
    """Table 5's loss constants (dB).

    A transiting wavelength only suffers the MR *pass* loss (0.005 dB) at
    intermediate routers; the 0.5 dB MR *drop* loss and the 0.5 dB splitter
    apply once, at the receiver, and are folded into il_oe_db.  Link length
    is ~0.2 mm/hop for a 1000-router ring on a 20 mm die edge.
    """

    il_link_db: float = 1.5 * 0.02  # waveguide 1.5 dB/cm × 0.02 cm/hop
    il_router_db: float = 0.005     # MR pass loss per transited router
    il_eo_db: float = 1.0           # coupler (E->O injection)
    il_oe_db: float = 1.0           # splitter 0.5 + MR drop 0.5 at receiver


def insertion_loss_db(n_routers: int, p: OpticalLossParams | None = None) -> float:
    """Eq. (19): IL = IL_l (N_r - 1) + IL_r N_r + IL_eo + IL_oe."""
    p = p or OpticalLossParams()
    if n_routers < 1:
        return 0.0
    return (
        p.il_link_db * (n_routers - 1)
        + p.il_router_db * n_routers
        + p.il_eo_db
        + p.il_oe_db
    )


def memory_per_core_bytes(
    workload: FCNNWorkload,
    mapping: Mapping,
    psi_bytes: int = 4,
) -> np.ndarray:
    """Eq. (20): per-core SRAM requirement, exact from the mapping matrix.

    Per neuron of layer i the paper charges s_i = (3 n_{i-1} + 4) µ ψ
    (FP: n_{i-1} weights + 1 bias + n_{i-1} inputs + 1 output;
     BP adds n_{i-1} weight gradients + 1 bias gradient + 1 learning rate),
    with µ the batch size (inputs/outputs are per-sample; weights are not,
    the paper's s_i upper-bounds both by µψ).
    """
    mu = workload.batch_size
    mem = np.zeros(mapping.m, dtype=np.float64)
    assignment = neuron_assignment(workload, mapping)
    for layer, cores in assignment.items():
        n_prev = workload.n(layer - 1)
        s_i = (3 * n_prev + 4) * mu * psi_bytes
        np.add.at(mem, cores, s_i)
    return mem


def max_memory_requirement_bytes(
    workload: FCNNWorkload, mapping: Mapping, psi_bytes: int = 4
) -> float:
    """Table 3's quantity: max over cores of Eq. (20)."""
    return float(memory_per_core_bytes(workload, mapping, psi_bytes).max())


@dataclasses.dataclass(frozen=True)
class StrategyReport:
    strategy: str
    hotspot_consecutive_periods: int
    state_transitions: int
    state_transitions_closed_form: int
    max_path_length_hops: int
    worst_insertion_loss_db: float
    max_memory_bytes: float
    active_core_count: int


def analyze_mapping(
    workload: FCNNWorkload,
    mapping: Mapping,
    psi_bytes: int = 4,
    loss: OpticalLossParams | None = None,
) -> StrategyReport:
    """One-stop report used by benchmarks and the planner."""
    path = max_path_length(mapping)
    return StrategyReport(
        strategy=mapping.strategy.value,
        hotspot_consecutive_periods=hotspot_consecutive_periods(mapping),
        state_transitions=state_transitions(mapping),
        state_transitions_closed_form=state_transitions_closed_form(mapping),
        max_path_length_hops=path,
        worst_insertion_loss_db=insertion_loss_db(max(1, path + 1), loss),
        max_memory_bytes=max_memory_requirement_bytes(workload, mapping, psi_bytes),
        active_core_count=len(mapping.active_cores()),
    )
