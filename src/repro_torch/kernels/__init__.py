"""Hand-written CUDA kernels — the five of the FCNN training step (the
two softmax cross-entropy kernels also carry the LM's token loss) and the
two of the LM prefill (flash attention, the SSD intra-chunk term) — their
plain PyTorch versions (``ref.py``) and the ops over them (``ops.py``).
The extension is built on first use (``_build.py``)."""

from repro_torch.kernels.ops import (  # noqa: F401
    KERNELS,
    fcnn_layer,
    flash_attention,
    launch_counts,
    reset_launches,
    softmax_xent,
    ssd_chunk,
)
