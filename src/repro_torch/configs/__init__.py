"""Configurations of the port: the paper's FCNN benchmarks NN1–NN6 and
the LM architectures the port runs (importing this package registers
them; ``get_config(name)`` / ``smoke_config(name)`` fetch them)."""

from repro_torch.configs.base import (  # noqa: F401
    LONG_CONTEXT_FAMILIES,
    SHAPES,
    ModelConfig,
    ShapeSpec,
    get_config,
    list_archs,
    shape_cells,
    smoke_config,
)
from repro_torch.configs.nn_benchmarks import (  # noqa: F401
    BATCH_SIZES,
    NN_BENCHMARKS,
)

# one import per architecture — registration is a side effect
from repro_torch.configs import (  # noqa: F401,E402
    granite_3_2b,
    granite_moe_1b,
    mamba2_2_7b,
    qwen1_5_110b,
    qwen2_5_14b,
    qwen2_moe_a2_7b,
    qwen2_vl_72b,
    qwen3_14b,
    seamless_m4t_large_v2,
    zamba2_1_2b,
)
