"""Plain PyTorch versions of the five FCNN kernels.

Each function computes what its CUDA kernel computes, with PyTorch ops in
fp32.  The kernel wrappers run these for tensors on the CPU, ``ops``
runs them (under autograd) for ``mode="ref"``, and ``chip_smoke.py``
holds each kernel against its plain version on the card.  Counterparts:
``repro/kernels/ref.py`` in the JAX reference.
"""

from __future__ import annotations

import torch

__all__ = [
    "ACTIVATIONS",
    "act_deriv_from_output",
    "apply_activation",
    "fcnn_layer_ref",
    "fcnn_layer_dgrad_ref",
    "fcnn_layer_wgrad_ref",
    "softmax_xent_fwd_ref",
    "softmax_xent_dlogits_ref",
]

ACTIVATIONS = ("sigmoid", "relu", "tanh", "none")


def apply_activation(z: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "sigmoid":
        return torch.sigmoid(z)
    if activation == "relu":
        return torch.relu(z)
    if activation == "tanh":
        return torch.tanh(z)
    if activation == "none":
        return z
    raise ValueError(f"unknown activation {activation!r}")


def act_deriv_from_output(y: torch.Tensor, activation: str) -> torch.Tensor:
    """A'(z) expressed via the activation output y (fp32 in, fp32 out).

    The one table of derivatives: the CUDA kernels' ``act_deriv`` in
    ``csrc/fcnn_layer.cu`` implements the same four lines."""
    if activation == "sigmoid":
        return y * (1.0 - y)
    if activation == "relu":
        return (y > 0).to(torch.float32)
    if activation == "tanh":
        return 1.0 - y * y
    if activation == "none":
        return torch.ones_like(y)
    raise ValueError(f"unknown activation {activation!r}")


def _dz(dy: torch.Tensor, y: torch.Tensor, activation: str) -> torch.Tensor:
    return dy.float() * act_deriv_from_output(y.float(), activation)


def fcnn_layer_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   activation: str = "sigmoid") -> torch.Tensor:
    """One FCNN period: act(x @ w + b).  x: (M, K), w: (K, N), b: (N,)."""
    z = x.float() @ w.float() + b.float()
    return apply_activation(z, activation).to(x.dtype)


def fcnn_layer_dgrad_ref(dy: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                         activation: str = "sigmoid") -> torch.Tensor:
    """dX = (dY ⊙ A'(Y)) @ Wᵀ.  dy, y: (M, N); w: (K, N) -> (M, K)."""
    return (_dz(dy, y, activation) @ w.float().T).to(dy.dtype)


def fcnn_layer_wgrad_ref(x: torch.Tensor, dy: torch.Tensor, y: torch.Tensor,
                         activation: str = "sigmoid"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dW, db) = (Xᵀ @ dZ, Σ_rows dZ).  x: (M, K); dy, y: (M, N)."""
    dz = _dz(dy, y, activation)
    return (x.float().T @ dz).to(x.dtype), dz.sum(0).to(dy.dtype)


def softmax_xent_fwd_ref(logits: torch.Tensor, labels: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row cross-entropy: (nll, lse), both (B,) fp32, with
    nll[r] = lse[r] − logits[r, labels[r]]."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    picked = x.gather(1, labels.long()[:, None])[:, 0]
    return lse - picked, lse


def softmax_xent_dlogits_ref(logits: torch.Tensor, labels: torch.Tensor,
                             lse: torch.Tensor, scale: torch.Tensor
                             ) -> torch.Tensor:
    """dlogits = (exp(logits − lse) − onehot(labels)) · scale[:, None]."""
    x = logits.float()
    p = torch.exp(x - lse[:, None])
    onehot = torch.nn.functional.one_hot(labels.long(), x.shape[1]).float()
    return ((p - onehot) * scale[:, None]).to(logits.dtype)
