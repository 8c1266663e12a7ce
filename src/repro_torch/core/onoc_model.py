"""The paper's fine-grained parallel computing model (Section 3).

Copied from the reference ``repro/core/onoc_model.py``, unchanged.

One training epoch of an (l+1)-layer FCNN is divided into 2l *periods*:
Period 1..l    = forward propagation through layers 1..l,
Period l+1..2l = back propagation (period i touches layer 2l-i+1).

Everything here is the paper's math:

  Eq. (4)  X_i        neurons per core in period i
  Eq. (5)  f(m_i)     per-core compute time of period i
  Eq. (6)  g(m_i)     WDM/TDM communication time of period i
  Eq. (7)  T          epoch time
  Lemma 1  m_i*       closed-form optimal core count per period
  Theorem 1 T*        minimal epoch time

On B_i and Lemma 1 (a modelling note recorded in DESIGN.md §6): the paper
defines B_i as "the amount of time for one core in Period i to complete the
communications" and then differentiates T treating B_i as a constant.  A
sender's time has two parts:

  B_i(m_i) = B_setup + payload(X_i · mu)            (this module's model)

where B_setup is the fixed per-transmission cost (RWA/router configuration,
SRAM front/back-end access, E/O-O/E conversion pipeline fill) and
payload(X_i·mu) is the wire + per-flit time of the X_i = ceil(n_i/m_i)
neuron outputs over the mu-sample batch.  In the continuous relaxation,

  g(m) = (m/λ)(B_setup + p·n·mu/m) = m·B_setup/λ + p·n·mu/λ,

so the payload term is *invariant in m* (the total broadcast volume is
fixed) and drops from dT/dm — Lemma 1 therefore holds exactly with
B_i := B_setup.  The discrete simulator keeps the full staircase
ceil(m/λ)·B_i(m_i); the gap between the two is pure discretization, which
is what produces the small nonzero APE the paper reports in Table 7.

Eq. (6) sets g = 0 for periods 1, l and 2l.  With g(m_1) = 0, dT/dm_1 < 0
everywhere and Lemma 1's Case I degenerates to the clamp
m_1* = min(φ·m, n_1) — which is exactly what every row of the paper's
Table 10 shows (the first entry is always min(m, n_1) = 1000).  We follow
that operative rule; the published Case-I formula with B_1 in the
denominator is superseded by Eq. (6)'s own convention.

Units: C is core compute capacity in MAC/s; alpha/beta are MAC counts;
B_i is seconds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = [
    "ONoCConfig",
    "FCNNWorkload",
    "PeriodCosts",
    "compute_time",
    "comm_time",
    "slot_time",
    "epoch_time",
    "theta",
    "optimal_cores",
    "optimal_cores_continuous",
    "optimal_epoch_time",
    "brute_force_optimal_cores",
    "prediction_error",
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
    # + EO/OE pipeline fill.  103 core cycles ≈ 30.3 ns, calibrated so the
    # Lemma-1 optimum for NN1 layer 2 at (BS=1, λ=8) reproduces the paper's
    # Table 10 value of 257 cores (see DESIGN.md §6).
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

    alpha_i : MACs per neuron in FP period i over all samples — one MAC per
              incoming connection per sample plus the activation (one
              MAC-equivalent): alpha_i = mu * (n_{i-1} + 1).
    beta_i  : MAC-equivalents per connection weight-update in BP period i
              over all samples (gradient accumulation over mu samples,
              Eq. (2), plus the update, Eq. (3)): beta = mu + 1.
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


def _neurons_in_period(workload: FCNNWorkload, i: int) -> int:
    return workload.n(period_layer(workload, i))


def neurons_per_core(workload: FCNNWorkload, i: int, m_i: int) -> int:
    """X_i, Eq. (4)."""
    if m_i < 1:
        raise ValueError("m_i >= 1")
    return math.ceil(_neurons_in_period(workload, i) / m_i)


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


@dataclasses.dataclass(frozen=True)
class PeriodCosts:
    period: int
    layer: int
    m: int
    compute_s: float
    comm_s: float

    @property
    def total_s(self) -> float:
        return self.compute_s + self.comm_s


def epoch_time(
    workload: FCNNWorkload, cfg: ONoCConfig, cores: Sequence[int]
) -> tuple[float, list[PeriodCosts]]:
    """T, Eq. (7): epoch seconds given per-FP-period core counts.

    ``cores`` has length l (FP periods); BP periods reuse them via the
    data-locality constraint Eq. (11): m_{2l-i+1} = m_i.
    """
    l = workload.l
    if len(cores) != l:
        raise ValueError(f"need {l} per-period core counts, got {len(cores)}")
    per_period: list[PeriodCosts] = []
    total = cfg.d_input_s
    for i in range(1, 2 * l + 1):
        m_i = int(cores[i - 1]) if i <= l else int(cores[2 * l - i])  # Eq. (11)
        _check_constraints(workload, cfg, i, m_i)
        f = compute_time(workload, cfg, i, m_i)
        g = comm_time(workload, cfg, i, m_i)
        total += f + g + cfg.zeta_s
        per_period.append(
            PeriodCosts(period=i, layer=period_layer(workload, i), m=m_i,
                        compute_s=f, comm_s=g)
        )
    return total, per_period


def _check_constraints(
    workload: FCNNWorkload, cfg: ONoCConfig, i: int, m_i: int
) -> None:
    if m_i < 1:
        raise ValueError(f"period {i}: m_i must be >= 1")
    if m_i > cfg.phi * cfg.m + 1e-9:  # Eq. (9)
        raise ValueError(f"period {i}: m_i={m_i} exceeds phi*m={cfg.phi * cfg.m}")
    if m_i > _neurons_in_period(workload, i):  # Eq. (10)
        raise ValueError(
            f"period {i}: m_i={m_i} exceeds neurons "
            f"{_neurons_in_period(workload, i)}"
        )


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

    m_i = sqrt(θ_i / (B·C)) with
      B = 0                 for i = 1   (g(m_1) = g(m_2l) = 0 per Eq. (6):
                                         m_1 is unconstrained by comm, so
                                         m_1* = min(φ·m, n_1) — Table 10)
      B = B_i + B_{2l-i+1}  for 1 < i < l
      B = B_{l+1}           for i = l   (g(m_l) = 0; only the BP side pays)
    with B := the fixed setup component (see module docstring).
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

    ``refine_plateau=True`` applies a closed-form beyond-paper refinement:
    snap m* down to the plateau edge ceil(n_i / X) with X = ceil(n_i/m*).
    Fewer cores with the *same* X_i have identical compute time but strictly
    fewer TDM slots — the continuous relaxation cannot see this because it
    uses X = n/m without the ceiling.  Then compare against the adjacent
    plateau (X-1) edge and keep the cheaper one.  Still O(1) per period, no
    search.
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


def optimal_epoch_time(
    workload: FCNNWorkload, cfg: ONoCConfig, refine_plateau: bool = False
) -> tuple[float, list[int], list[PeriodCosts]]:
    """Theorem 1: T* with the Lemma-1 allocation."""
    stars = optimal_cores(workload, cfg, refine_plateau=refine_plateau)
    t, periods = epoch_time(workload, cfg, stars)
    return t, stars, periods


def brute_force_optimal_cores(
    workload: FCNNWorkload,
    cfg: ONoCConfig,
    candidates: Sequence[int] | None = None,
) -> list[int]:
    """Simulated optimum: per-period argmin over explicit core counts.

    T is separable per FP period (each m_i only affects periods i and
    2l-i+1 — Eq. 11), so the global argmin is the per-period argmin.  This
    mirrors the paper's per-layer sweep in Fig. 7.
    """
    l = workload.l
    if candidates is None:
        candidates = range(1, cfg.m + 1)
    out: list[int] = []
    for i in range(1, l + 1):
        best_m, best_t = 1, float("inf")
        cap = min(int(cfg.phi * cfg.m), workload.n(i))
        for m_i in candidates:
            if not 1 <= m_i <= cap:
                continue
            t = (
                compute_time(workload, cfg, i, m_i)
                + comm_time(workload, cfg, i, m_i)
                + compute_time(workload, cfg, 2 * l - i + 1, m_i)
                + comm_time(workload, cfg, 2 * l - i + 1, m_i)
            )
            if t < best_t - 1e-15:
                best_t, best_m = t, m_i
        out.append(best_m)
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


def prediction_error(
    workload: FCNNWorkload,
    cfg: ONoCConfig,
    plateau_tol: float = 0.005,
    refine_plateau: bool = False,
) -> tuple[float, float, float]:
    """(APE_raw, APE_plateau, APD) as in paper Table 7.

    APE_raw:     mean |m* - argmin| / argmin over FP periods.  Unstable when
                 the objective is flat near the optimum (plateau degeneracy:
                 ceil(n_i/m) steps make many m time-equivalent).
    APE_plateau: mean distance from m* to the *set* of near-optimal core
                 counts (period-pair time within ``plateau_tol`` of the
                 minimum) — the argmin-stable analogue of the paper's APE.
    APD:         relative epoch-time difference of the m* plan vs argmin
                 plan (the paper's Average Performance Difference).
    """
    stars = optimal_cores(workload, cfg, refine_plateau=refine_plateau)
    sim = brute_force_optimal_cores(workload, cfg)
    ape_raw = float(np.mean([abs(a - b) / b for a, b in zip(stars, sim)]))

    l = workload.l
    plateau_err = []
    for i in range(1, l + 1):
        cap = min(int(cfg.phi * cfg.m), workload.n(i))
        times = np.array(
            [_period_pair_time(workload, cfg, i, m) for m in range(1, cap + 1)]
        )
        t_min = times.min()
        near = np.flatnonzero(times <= t_min * (1.0 + plateau_tol)) + 1
        m_star = stars[i - 1]
        d = np.min(np.abs(near - m_star) / near)
        plateau_err.append(float(d))
    ape_plateau = float(np.mean(plateau_err))

    t_star, _ = epoch_time(workload, cfg, stars)
    t_sim, _ = epoch_time(workload, cfg, sim)
    apd = abs(t_star - t_sim) / max(t_sim, 1e-30)
    return ape_raw, ape_plateau, float(apd)
