"""The paper's FCNN benchmarks (Table 6) and evaluation grid (§5), copied
from the reference ``repro/configs/nn_benchmarks.py``."""

from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig

NN_BENCHMARKS: dict[str, list[int]] = {
    "NN1": [784, 1000, 500, 10],
    "NN2": [784, 1500, 784, 1000, 500, 10],
    "NN3": [784, 2000, 1500, 784, 1000, 500, 10],
    "NN4": [784, 2500, 2000, 1500, 784, 1000, 500, 10],
    "NN5": [1024, 4000, 1000, 4000, 10],
    "NN6": [1024, 4000, 1000, 4000, 1000, 4000, 1000, 4000, 10],
}

BATCH_SIZES = (1, 8, 32, 64, 128)
WAVELENGTHS = (8, 64)
FNP_FIXED_CORES = 200                       # paper §5.3
ENOC_CORE_SWEEP = (40, 65, 90, 150, 250, 350)  # paper §5.4 / Fig. 10


def workload(name: str, batch_size: int = 1) -> FCNNWorkload:
    return FCNNWorkload(NN_BENCHMARKS[name], batch_size=batch_size)


def onoc_config(lambda_max: int = 64, m: int = 1000) -> ONoCConfig:
    return ONoCConfig(m=m, lambda_max=lambda_max)
