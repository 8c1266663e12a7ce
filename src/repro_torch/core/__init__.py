"""The paper's ONoC cost model, core mapping, analyses, wavelength
schedule, energy model, baselines, planner and epoch simulator
(framework-free copies of the reference's ``repro.core`` modules)."""

from .onoc_model import (  # noqa: F401
    FCNNWorkload,
    ONoCConfig,
    PeriodCosts,
    brute_force_optimal_cores,
    comm_time,
    compute_time,
    epoch_time,
    optimal_cores,
    optimal_cores_continuous,
    optimal_epoch_time,
    prediction_error,
    theta,
)
from .allocation import (  # noqa: F401
    Mapping,
    MappingStrategy,
    expected_reuse,
    map_cores,
    neuron_assignment,
    reuse_counts,
)
from .analyses import (  # noqa: F401
    StrategyReport,
    analyze_mapping,
    hotspot_consecutive_periods,
    insertion_loss_db,
    max_memory_requirement_bytes,
    max_path_length,
    memory_per_core_bytes,
    state_transitions,
)
from .wavelength import assign_wavelengths, schedule_epoch  # noqa: F401
from .planner import (  # noqa: F401
    FCNNPlan,
    PeriodPlan,
    feasible_degrees,
    plan_fcnn,
    ring_mesh_axes,
)
from .simulator import (  # noqa: F401
    ENoCBackend,
    ENoCConfig,
    EpochTrace,
    ONoCBackend,
    simulate_epoch,
)
from .energy import EnergyBreakdown, EnergyParams, enoc_energy, onoc_energy  # noqa: F401
from .baselines import fgp_cores, fnp_cores  # noqa: F401
