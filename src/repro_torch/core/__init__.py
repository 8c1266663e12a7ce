"""The paper's ONoC cost model, core mapping, planner and epoch simulator
(framework-free copies of the reference's ``repro.core`` modules)."""

from .onoc_model import (  # noqa: F401
    FCNNWorkload,
    ONoCConfig,
    comm_time,
    compute_time,
    optimal_cores,
)
from .allocation import Mapping, MappingStrategy, map_cores  # noqa: F401
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
