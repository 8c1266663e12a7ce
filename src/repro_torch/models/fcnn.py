"""The paper's FCNN (NN1..NN6) in PyTorch, counterpart of the reference
``repro/models/fcnn.py``.

Layer i computes Y = A(X W + b) (Eq. 1): sigmoid in hidden layers, and
softmax + cross-entropy at the output (§5.1).  Parameters keep the
reference's pytree layout, ``{"layers": [{"w": (n_in, n_out), "b":
(n_out,)}, ...]}``, as a dict of tensors, so ``params_from_numpy`` takes
the reference's parameters (as numpy) unchanged.  Every one of the 2l
periods goes through ``kernels.ops``: the fused ``fcnn_layer`` forward
with its dgrad/wgrad backward, and the fused ``softmax_xent`` output
period.  ``kernel_mode`` threads through ``loss_fn`` and ``accuracy``
alike so evaluation takes the training path.

Parameters are fp32 or bf16 (``init``'s ``dtype``, or the reference's
tree as it comes), and the data fp32 or bf16; as in the reference, every
dtype follows the tensors: a layer's output takes its input's dtype, so
fp32 data through a bf16 network keeps fp32 activations against bf16
weights, and each gradient takes its parameter's dtype.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import tree as _tree

Params = dict[str, Any]

__all__ = ["init", "params_from_numpy", "params_to_numpy", "parameters",
           "period_activation", "forward", "loss_fn", "accuracy"]


def init(layer_sizes: Sequence[int], generator: torch.Generator,
         device: torch.device | str, dtype: torch.dtype = torch.float32
         ) -> Params:
    """layer_sizes = [n_0, ..., n_l]; w ~ N(0, 1)/√n_in, b = 0.

    Draws in fp32 on ``generator`` (a CPU generator, so a seed gives the
    same weights on every device), rounds once to ``dtype`` (as the
    reference's ``init(key, sizes, dtype)`` does) and moves the result to
    ``device``.  The tensors require grad."""
    layers = []
    for n_in, n_out in zip(layer_sizes[:-1], layer_sizes[1:]):
        w = torch.randn((n_in, n_out), generator=generator) / math.sqrt(n_in)
        layers.append({"w": w.to(dtype), "b": torch.zeros(n_out, dtype=dtype)})
    return _as_leaves({"layers": layers}, device)


def params_from_numpy(tree: dict, device: torch.device | str = "cpu") -> Params:
    """The reference's ``{"layers": [{"w", "b"}, ...]}`` pytree, given as
    numpy arrays (``jax.tree.map(np.asarray, params)``), as the port's
    parameters on ``device``, each leaf in its own dtype: bfloat16 leaves
    (ml_dtypes arrays) arrive as ``torch.bfloat16``, exactly, as
    ``models.tree.params_from_numpy`` carries them."""
    layers = [{k: _tree.tensor_from_numpy(lp[k], "cpu") for k in ("w", "b")}
              for lp in tree["layers"]]
    return _as_leaves({"layers": layers}, device)


def params_to_numpy(params: Params) -> dict:
    """The parameters as the reference's tree would give them as numpy:
    fp32 leaves as float32 arrays, bf16 ones as ``ml_dtypes.bfloat16``
    arrays (the type ``np.asarray`` gives a bf16 jax array; ml_dtypes is
    imported only for such a leaf)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return {"layers": [{k: leaf(v) for k, v in lp.items()}
                       for lp in params["layers"]]}


def parameters(params: Params) -> list[torch.Tensor]:
    """The leaves in a fixed order: w1, b1, w2, b2, ..."""
    return [lp[k] for lp in params["layers"] for k in ("w", "b")]


def _as_leaves(tree: Params, device) -> Params:
    return {"layers": [{k: v.to(device).requires_grad_(True)
                        for k, v in lp.items()} for lp in tree["layers"]]}


def period_activation(layer: int, l: int) -> str:  # noqa: E741 — paper notation
    """Activation of FP period/layer ``layer`` (1-based) in an l-layer FCNN:
    sigmoid in hidden layers, none at the output (softmax lives in the
    loss period)."""
    return "sigmoid" if layer < l else "none"


def forward(params: Params, x: torch.Tensor,
            kernel_mode: str | None = None) -> torch.Tensor:
    """x: (B, n_0) -> logits (B, n_l).  Period i = one loop iteration."""
    h = x
    n = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        h = ops.fcnn_layer(h, lp["w"], lp["b"], period_activation(i + 1, n),
                           mode=kernel_mode)
    return h


def loss_fn(params: Params, batch: dict[str, torch.Tensor],
            kernel_mode: str | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy: the fused output period."""
    logits = forward(params, batch["x"], kernel_mode=kernel_mode)
    return ops.softmax_xent(logits, batch["y"], mode=kernel_mode)


@torch.no_grad()
def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor,
             kernel_mode: str | None = None) -> torch.Tensor:
    """Share of rows whose argmax logit is the label (0-d fp32 tensor on
    the device; reading it is the caller's sync)."""
    logits = forward(params, x, kernel_mode=kernel_mode)
    return (logits.argmax(dim=-1) == y).to(torch.float32).mean()
