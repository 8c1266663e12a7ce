"""The paper's FCNN benchmarks (Table 6) and batch sizes (§5), copied
from the reference ``repro/configs/nn_benchmarks.py``."""

NN_BENCHMARKS: dict[str, list[int]] = {
    "NN1": [784, 1000, 500, 10],
    "NN2": [784, 1500, 784, 1000, 500, 10],
    "NN3": [784, 2000, 1500, 784, 1000, 500, 10],
    "NN4": [784, 2500, 2000, 1500, 784, 1000, 500, 10],
    "NN5": [1024, 4000, 1000, 4000, 10],
    "NN6": [1024, 4000, 1000, 4000, 1000, 4000, 1000, 4000, 10],
}

BATCH_SIZES = (1, 8, 32, 64, 128)

