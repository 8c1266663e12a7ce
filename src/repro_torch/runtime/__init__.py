from .fault_tolerance import TrainingSupervisor, StragglerMonitor  # noqa: F401
from .elastic import ElasticPlanner  # noqa: F401
from .faults import (  # noqa: F401
    DeviceLossFault,
    EpochFaults,
    FaultError,
    FaultEvent,
    FaultInjector,
    FaultKind,
    FaultReport,
    FaultSchedule,
    TransientRunFault,
    expected_epoch_time,
)
from .degraded import DegradedModeRunner  # noqa: F401
