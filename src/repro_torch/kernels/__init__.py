"""Hand-written CUDA kernels of the FCNN training step, their plain
PyTorch versions (``ref.py``) and the differentiable ops over them
(``ops.py``).  The extension is built on first use (``_build.py``)."""

from repro_torch.kernels.ops import (  # noqa: F401
    KERNELS,
    fcnn_layer,
    launch_counts,
    reset_launches,
    softmax_xent,
)
