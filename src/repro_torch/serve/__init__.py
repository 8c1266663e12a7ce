"""repro_torch.serve — continuous-batching serving on one card,
counterpart of the reference ``repro.serve``:

  traffic.py    seeded open-loop traffic (copied whole: bit-identical
                traces).
  scheduler.py  SlotManager + the continuous-batching ServingEngine
                (copied).
  elastic.py    Lemma-1 ServeAutoscaler and ReplanDecision (copied, over
                the port's ElasticPlanner).
  runner.py     PyTorch backend on a logical ring of n devices on one card
                (batch-1 prefill at the prompt's bucket, per-slot in-place
                cache merge, batched greedy decode).
  metrics.py    TTFT/TPOT/e2e percentiles, throughput/goodput SLO report
                (copied whole).
"""

from repro_torch.serve.elastic import ReplanDecision, ServeAutoscaler
from repro_torch.serve.metrics import RequestRecord, ServeMetrics, SLOReport
from repro_torch.serve.runner import TorchModelRunner, snap_prompt_buckets
from repro_torch.serve.scheduler import (
    EngineResult,
    ModelRunner,
    Request,
    ServingEngine,
    SlotManager,
    TickClock,
    WallClock,
)
from repro_torch.serve.traffic import (
    RequestEvent,
    Scenario,
    SCENARIO_NAMES,
    TrafficTrace,
    make_traffic,
    prompt_tokens,
    scenario_preset,
)

__all__ = [
    "ReplanDecision",
    "ServeAutoscaler",
    "RequestRecord",
    "ServeMetrics",
    "SLOReport",
    "TorchModelRunner",
    "snap_prompt_buckets",
    "EngineResult",
    "ModelRunner",
    "Request",
    "ServingEngine",
    "SlotManager",
    "TickClock",
    "WallClock",
    "RequestEvent",
    "Scenario",
    "SCENARIO_NAMES",
    "TrafficTrace",
    "make_traffic",
    "prompt_tokens",
    "scenario_preset",
]
