"""PyTorch/CUDA port of the ONoC FCNN system.

The JAX package ``repro`` (beside this one under ``src/``) is the
reference; this package imports nothing of it and never imports jax.  Its
layout mirrors the reference's subpackages (``core``, ``configs``,
``data``, ``kernels``, ``models``, ``optim``, ``parallel``, ``serve``,
``launch``) so each module has an obvious counterpart.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``
(see ``repro_torch.device.resolve_device``); there is no silent CPU
fallback.  On CUDA tensors every period of the FCNN training step goes
through one of five hand-written CUDA kernels, and every LM prefill
through two more — flash attention (every attention of a prompt) and the
SSD intra-chunk term (every Mamba2 layer) (``repro_torch.kernels``).  The
LM train step (``launch.steps``) takes its token cross-entropy through the
FCNN's softmax cross-entropy kernels at vocabulary width; attention and
the SSD train on their plain versions, as the reference trains through
jnp.
"""

from repro_torch.device import resolve_device  # noqa: F401
