"""Energy model for ONoC vs ENoC — paper Section 5 (Fig. 9 / Fig. 10b).

Copied from the reference ``repro/core/energy.py``, unchanged.

The paper computes energy with DSENT-derived constants and the model of
Grani & Bartolini [22]:

  ONoC total = static (laser + MR thermal tuning + core leakage) × T_epoch
             + dynamic (E/O + O/E conversion per bit + core compute energy)
  ENoC total = static (router + core leakage) × T_epoch
             + dynamic (per-bit per-hop router+link energy + compute energy)

Laser power is derived from the worst-case insertion loss (Eq. 19), the
receiver sensitivity and the laser wall-plug efficiency (30%, Table 5) —
longer paths through more optical elements need exponentially more laser
power (dB → linear), which is how the mapping strategy's max path length
(Table 2) feeds energy.

Constants below are DSENT-class values from the ONoC literature; they are
configuration, not measurement — EXPERIMENTS.md treats only *relative*
ONoC/ENoC results as reproduction targets, matching the paper's own use.
"""

from __future__ import annotations

import dataclasses

from .analyses import OpticalLossParams, insertion_loss_db, max_path_length
from .allocation import Mapping
from .simulator import EpochTrace

__all__ = ["EnergyParams", "EnergyBreakdown", "onoc_energy", "enoc_energy"]


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    # --- shared / core ---
    core_active_w: float = 0.20          # per-core active power (compute)
    core_idle_w: float = 0.02            # per-core leakage
    # --- ONoC ---
    eo_oe_pj_per_bit: float = 1.0        # modulator + photodetector dynamic
    mr_tuning_uw: float = 20.0           # per-MR thermal tuning (static)
    mrs_per_router: int = 16             # MRs in a configurable router (Fig. 3)
    receiver_sensitivity_dbm: float = -20.0
    laser_efficiency: float = 0.30       # Table 5
    # --- ENoC ---
    router_pj_per_bit: float = 0.60      # per-hop router traversal
    link_pj_per_bit: float = 0.25        # per-hop link traversal
    router_leak_w: float = 0.005         # per-router static
    state_transition_nj: float = 5.0     # per active<->idle transition (both)


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    static_j: float
    dynamic_j: float
    compute_j: float

    @property
    def total_j(self) -> float:
        return self.static_j + self.dynamic_j + self.compute_j


def _laser_power_w(mapping: Mapping, p: EnergyParams,
                   loss: OpticalLossParams | None = None) -> float:
    """Off-chip laser power needed to close the worst-case link budget."""
    hops = max_path_length(mapping)
    il_db = insertion_loss_db(max(1, hops + 1), loss)
    # required optical output = sensitivity + losses, per wavelength
    p_out_dbm = p.receiver_sensitivity_dbm + il_db
    p_out_w = 10 ** (p_out_dbm / 10) / 1000.0
    return p_out_w / p.laser_efficiency


def onoc_energy(
    trace: EpochTrace,
    mapping: Mapping,
    n_state_transitions: int = 0,
    params: EnergyParams | None = None,
    loss: OpticalLossParams | None = None,
) -> EnergyBreakdown:
    p = params or EnergyParams()
    t = trace.total_s
    n_active = len(mapping.active_cores())

    laser_w = _laser_power_w(mapping, p, loss)
    tuning_w = p.mr_tuning_uw * 1e-6 * p.mrs_per_router * n_active
    idle_w = p.core_idle_w * mapping.m
    static = (laser_w + tuning_w + idle_w) * t

    bits = trace.total_bytes * 8.0
    dynamic = bits * p.eo_oe_pj_per_bit * 1e-12
    dynamic += n_state_transitions * p.state_transition_nj * 1e-9

    compute = float(trace.core_busy_s.sum()) * p.core_active_w
    return EnergyBreakdown(static_j=static, dynamic_j=dynamic, compute_j=compute)


def enoc_energy(
    trace: EpochTrace,
    mapping: Mapping,
    n_state_transitions: int = 0,
    params: EnergyParams | None = None,
) -> EnergyBreakdown:
    p = params or EnergyParams()
    t = trace.total_s
    static = (p.router_leak_w * mapping.m + p.core_idle_w * mapping.m) * t

    hop_bits = trace.total_hop_bytes * 8.0
    dynamic = hop_bits * (p.router_pj_per_bit + p.link_pj_per_bit) * 1e-12
    dynamic += n_state_transitions * p.state_transition_nj * 1e-9

    compute = float(trace.core_busy_s.sum()) * p.core_active_w
    return EnergyBreakdown(static_j=static, dynamic_j=dynamic, compute_j=compute)
