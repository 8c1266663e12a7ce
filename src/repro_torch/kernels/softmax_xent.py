"""Wrappers of the two softmax cross-entropy kernels
(``csrc/softmax_xent.cu``), the FCNN output period.

  softmax_xent_fwd      (nll, lse) per row            replaces repro/kernels/softmax_xent.py:111
  softmax_xent_dlogits  (exp(x − lse) − onehot)·scale replaces repro/kernels/softmax_xent.py:172

Same discipline as ``fcnn_layer.py``: checks, then the kernel on CUDA
tensors (counted in ``launches``) or the plain version on CPU tensors.
Labels are int32, as the dataset gives them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fcnn_layer import check_arg, device_type

__all__ = ["softmax_xent_fwd", "softmax_xent_dlogits"]


def _logits_shape(kernel: str, logits: torch.Tensor) -> tuple[int, int]:
    if logits.dim() != 2:
        raise ValueError(f"{kernel}: logits must be 2-D, got {logits.dim()}-D")
    return logits.shape[0], logits.shape[1]


def softmax_xent_fwd(logits: torch.Tensor, labels: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row cross-entropy.  logits: (B, C) fp32; labels: (B,) int32.
    Returns (nll, lse), both (B,) fp32, nll = lse − logits[r, labels[r]]."""
    b, c = _logits_shape("softmax_xent_fwd", logits)
    check_arg("softmax_xent_fwd", "logits", logits, (b, c))
    check_arg("softmax_xent_fwd", "labels", labels, (b,), torch.int32)
    if device_type("softmax_xent_fwd", logits, labels) == "cpu":
        return _ref.softmax_xent_fwd_ref(logits, labels)
    nll = torch.empty((b,), device=logits.device, dtype=torch.float32)
    lse = torch.empty((b,), device=logits.device, dtype=torch.float32)
    _build.extension().xent_fwd(logits, labels, nll, lse)
    softmax_xent_fwd.launches += 1
    return nll, lse


def softmax_xent_dlogits(logits: torch.Tensor, labels: torch.Tensor,
                         lse: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """dlogits = (softmax(logits) − onehot(labels)) · scale[:, None].
    logits: (B, C) fp32; labels: (B,) int32; lse, scale: (B,) fp32."""
    b, c = _logits_shape("softmax_xent_dlogits", logits)
    check_arg("softmax_xent_dlogits", "logits", logits, (b, c))
    check_arg("softmax_xent_dlogits", "labels", labels, (b,), torch.int32)
    check_arg("softmax_xent_dlogits", "lse", lse, (b,))
    check_arg("softmax_xent_dlogits", "scale", scale, (b,))
    if device_type("softmax_xent_dlogits", logits, labels, lse, scale) == "cpu":
        return _ref.softmax_xent_dlogits_ref(logits, labels, lse, scale)
    dx = torch.empty((b, c), device=logits.device, dtype=torch.float32)
    _build.extension().xent_dlogits(logits, labels, lse, scale, dx)
    softmax_xent_dlogits.launches += 1
    return dx


softmax_xent_fwd.launches = 0
softmax_xent_dlogits.launches = 0
