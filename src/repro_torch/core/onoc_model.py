"""The paper's fine-grained parallel computing model (Section 3), copied
from the reference ``repro/core/onoc_model.py`` and cut to what the FCNN
training slice uses: the platform and workload descriptions, Eq. (5)
compute time, Eq. (6) communication time and the Lemma-1 core counts.

One training epoch of an (l+1)-layer FCNN is divided into 2l periods:
Period 1..l = forward propagation through layers 1..l, Period l+1..2l =
back propagation (period i touches layer 2l-i+1).  B_i is modelled as a
fixed setup cost plus the payload of the X_i·mu neuron outputs; the
payload term is invariant in m in the continuous relaxation, so Lemma 1
holds with B_i := B_setup (the reference's module docstring derives this).

Units: C is core compute capacity in MAC/s; alpha/beta are MAC counts;
B_i is seconds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

__all__ = [
    "ONoCConfig",
    "FCNNWorkload",
    "compute_time",
    "comm_time",
    "slot_time",
    "theta",
    "optimal_cores",
    "optimal_cores_continuous",
    "period_layer",
    "neurons_per_core",
]


@dataclasses.dataclass(frozen=True)
class ONoCConfig:
    """Platform parameters (paper Tables 4 & 5)."""

    m: int = 1000                 # total cores on the ring
    lambda_max: int = 64          # available wavelengths (8 or 64 in the paper)
    C: float = 3.0e9              # MACs/s per core (6 GFLOPS peak => 3 GMAC/s)
    phi: float = 1.0              # utilization cap, Eq. (9) (paper sets phi=1)
    bandwidth_bps: float = 40e9   # per-wavelength bandwidth (Table 5)
    bytes_per_value: int = 4      # FP32 parameters
    core_hz: float = 3.4e9        # core frequency (Table 4)
    # Fixed per-transmission setup: RWA + router config + SRAM front/back end
    # + EO/OE pipeline fill, calibrated to the paper's Table 10 (NN1 layer 2
    # at BS=1, λ=8 -> 257 cores).
    setup_cycles: float = 103.0
    # Per-flit pipeline overheads (Table 5), cycles at core_hz.
    oe_eo_cycles: float = 1.0     # OE/EO delay, 1 cycle/flit
    tof_cycles: float = 1.0       # time of flight, 1 cycle/flit
    serialization_cycles: float = 2.0  # serialization, 2 cycles/flit
    flit_bytes: int = 16          # 16 bytes/flit (Section 5.4)
    sram_latency_cycles: float = 10.0  # distributed SRAM access (Table 4)
    d_input_s: float = 0.0        # Period-0 load time (constant w.r.t. m_i)
    zeta_s: float = 0.0           # per-period extra delay (constant)

    @property
    def setup_time_s(self) -> float:
        return self.setup_cycles / self.core_hz

    def payload_time_s(self, n_values: int) -> float:
        """Wire + per-flit pipeline time for n_values parameters."""
        payload_bytes = n_values * self.bytes_per_value
        n_flits = math.ceil(payload_bytes / self.flit_bytes)
        wire = payload_bytes * 8.0 / self.bandwidth_bps
        per_flit = (
            self.oe_eo_cycles
            + self.tof_cycles
            + self.serialization_cycles
            + self.sram_latency_cycles
        ) / self.core_hz
        return wire + n_flits * per_flit


@dataclasses.dataclass(frozen=True)
class FCNNWorkload:
    """An FCNN instance + training-batch description.

    ``layer_sizes`` = [n_0, n_1, ..., n_l]  (n_0 = input layer).
    ``batch_size``  = mu, samples per training epoch in the paper's model.

    alpha_i = mu * (n_{i-1} + 1) MACs per neuron in FP period i;
    beta    = mu + 1 MAC-equivalents per weight update in a BP period.
    """

    layer_sizes: Sequence[int]
    batch_size: int = 1

    def __post_init__(self) -> None:
        if len(self.layer_sizes) < 2:
            raise ValueError("an FCNN needs at least input and output layers")
        if any(n <= 0 for n in self.layer_sizes):
            raise ValueError(f"layer sizes must be positive: {self.layer_sizes}")
        if self.batch_size < 1:
            raise ValueError("batch_size >= 1")

    @property
    def l(self) -> int:  # noqa: E743 — paper notation
        return len(self.layer_sizes) - 1

    def n(self, layer: int) -> int:
        return int(self.layer_sizes[layer])

    def alpha(self, i: int) -> float:
        if not 1 <= i <= self.l:
            raise ValueError(f"FP period out of range: {i}")
        return float(self.batch_size) * (self.n(i - 1) + 1.0)

    def beta(self, i: int) -> float:
        if not self.l + 1 <= i <= 2 * self.l:
            raise ValueError(f"BP period out of range: {i}")
        return float(self.batch_size) + 1.0


def period_layer(workload: FCNNWorkload, i: int) -> int:
    """Layer touched by period i (paper Section 3.1)."""
    l = workload.l
    if 1 <= i <= l:
        return i
    if l + 1 <= i <= 2 * l:
        return 2 * l - i + 1
    raise ValueError(f"period out of range: {i} (l={l})")


def neurons_per_core(workload: FCNNWorkload, i: int, m_i: int) -> int:
    """X_i, Eq. (4)."""
    if m_i < 1:
        raise ValueError("m_i >= 1")
    return math.ceil(workload.n(period_layer(workload, i)) / m_i)


def compute_time(workload: FCNNWorkload, cfg: ONoCConfig, i: int, m_i: int) -> float:
    """f(m_i), Eq. (5) — seconds of compute on each of the m_i cores."""
    x_i = neurons_per_core(workload, i, m_i)
    l = workload.l
    if 1 <= i <= l:
        return workload.alpha(i) * x_i / cfg.C
    # BP: each neuron updates the weights of its connections to the previous
    # layer (n_{2l-i} of them) plus its bias — (n_{2l-i} + 1) updates.
    n_prev = workload.n(2 * l - i)
    return workload.beta(i) * x_i * (n_prev + 1.0) / cfg.C


def slot_time(workload: FCNNWorkload, cfg: ONoCConfig, i: int, m_i: int) -> float:
    """B_i(m_i) — seconds for one sender in period i (setup + payload)."""
    x_i = neurons_per_core(workload, i, m_i)
    return cfg.setup_time_s + cfg.payload_time_s(x_i * workload.batch_size)


def comm_time(workload: FCNNWorkload, cfg: ONoCConfig, i: int, m_i: int) -> float:
    """g(m_i), Eq. (6): ceil(m_i/λ)·B_i, zero for periods 1, l and 2l."""
    l = workload.l
    if i in (1, l, 2 * l):
        return 0.0
    slots = math.ceil(m_i / cfg.lambda_max)
    return slots * slot_time(workload, cfg, i, m_i)


def theta(workload: FCNNWorkload, cfg: ONoCConfig, i: int) -> float:
    """θ_i = n_i · λ_max · [β_{2l-i+1}(n_{i-1}+1) + α_i]   (Lemma 1)."""
    l = workload.l
    if not 1 <= i <= l:
        raise ValueError("theta is defined for FP periods 1..l")
    n_i = workload.n(i)
    n_prev = workload.n(i - 1)
    beta_bp = workload.beta(2 * l - i + 1)
    return n_i * cfg.lambda_max * (beta_bp * (n_prev + 1.0) + workload.alpha(i))


def optimal_cores_continuous(
    workload: FCNNWorkload, cfg: ONoCConfig
) -> list[float]:
    """Lemma 1's stationary points before ceiling/clamping (FP periods).

    m_i = sqrt(θ_i / (B·C)) with B = 0 for i = 1 (g(m_1) = 0, so
    m_1* = min(φ·m, n_1)), B = 2·B_setup for 1 < i < l and B = B_setup
    for i = l.
    """
    l = workload.l
    b_setup = cfg.setup_time_s
    out: list[float] = []
    for i in range(1, l + 1):
        th = theta(workload, cfg, i)
        if l == 1 or i == 1:
            b = 0.0  # no comm attributable to this period's core count
        elif i == l:
            b = b_setup
        else:
            b = 2.0 * b_setup
        if b <= 0.0:
            out.append(float("inf"))
        else:
            out.append(math.sqrt(th / (b * cfg.C)))
    return out


def optimal_cores(
    workload: FCNNWorkload, cfg: ONoCConfig, refine_plateau: bool = False
) -> list[int]:
    """Lemma 1: m_i* = min(ceil(m_i), φ·m, n_i) for FP periods i=1..l.

    ``refine_plateau=True`` snaps m* to the cheaper of this plateau's edge
    ceil(n_i / X) (X = ceil(n_i/m*)) and the next plateau's edge: fewer
    cores with the same X_i compute as fast and need fewer TDM slots.
    """
    cont = optimal_cores_continuous(workload, cfg)
    out: list[int] = []
    for i, m_unc in enumerate(cont, start=1):
        cap = min(int(cfg.phi * cfg.m), workload.n(i))  # Eqs. (9), (10)
        m_star = min(
            math.ceil(m_unc) if math.isfinite(m_unc) else cfg.m, cap
        )
        m_star = max(1, int(m_star))
        if refine_plateau:
            n_i = workload.n(i)
            cands = {m_star}
            x = math.ceil(n_i / m_star)
            cands.add(min(cap, math.ceil(n_i / x)))          # this plateau's edge
            if x > 1:
                cands.add(min(cap, math.ceil(n_i / (x - 1))))  # next plateau edge
            m_star = min(
                cands,
                key=lambda m: _period_pair_time(workload, cfg, i, m),
            )
        out.append(m_star)
    return out


def _period_pair_time(
    workload: FCNNWorkload, cfg: ONoCConfig, i: int, m_i: int
) -> float:
    """Combined FP+BP time of the (i, 2l-i+1) period pair at m_i cores."""
    l = workload.l
    return (
        compute_time(workload, cfg, i, m_i)
        + comm_time(workload, cfg, i, m_i)
        + compute_time(workload, cfg, 2 * l - i + 1, m_i)
        + comm_time(workload, cfg, 2 * l - i + 1, m_i)
    )
