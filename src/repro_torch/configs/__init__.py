"""Configurations of the port: the paper's FCNN benchmarks NN1–NN6."""

from repro_torch.configs.nn_benchmarks import (  # noqa: F401
    BATCH_SIZES,
    NN_BENCHMARKS,
)
