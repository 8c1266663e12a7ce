"""Wrappers of the two softmax cross-entropy kernels
(``csrc/softmax_xent.cu``), the FCNN output period.

  softmax_xent_fwd      (nll, lse) per row and their   replaces repro/kernels/softmax_xent.py:111
                        batch mean
  softmax_xent_dlogits  (exp(x − lse) − onehot)·scale  replaces repro/kernels/softmax_xent.py:172
                        with scale per row, or g/B

Logits are fp32 or bf16, as the reference takes them; nll, lse and the
mean are fp32 and dlogits has the logits' dtype.  Labels are int32, as the
dataset gives them.  The training step needs nothing around the kernels:
K4's mean is the loss and K5 takes the loss cotangent ``g`` itself.

Same discipline as ``fcnn_layer.py``: checks, then the kernel on CUDA
tensors (counted in ``launches``) or the plain version on CPU tensors.
The launchers size both kernels from (B, C) (see the CUDA source).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fcnn_layer import check_arg, device_type

__all__ = ["softmax_xent_fwd", "softmax_xent_dlogits"]

LOGIT_DTYPES = (torch.float32, torch.bfloat16)


def _logits(kernel: str, logits: torch.Tensor) -> tuple[int, int]:
    if logits.dim() != 2:
        raise ValueError(f"{kernel}: logits must be 2-D, got {logits.dim()}-D")
    if logits.dtype not in LOGIT_DTYPES:
        raise TypeError(f"{kernel}: logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    b, c = logits.shape
    check_arg(kernel, "logits", logits, (b, c), logits.dtype)
    return b, c


def softmax_xent_fwd(logits: torch.Tensor, labels: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row cross-entropy.  logits: (B, C) fp32 or bf16; labels: (B,)
    int32.  Returns (nll, lse, mean): nll = lse − logits[r, labels[r]] and
    lse, both (B,) fp32, and the mean of nll, a 0-d fp32 tensor."""
    b, c = _logits("softmax_xent_fwd", logits)
    check_arg("softmax_xent_fwd", "labels", labels, (b,), torch.int32)
    if device_type("softmax_xent_fwd", logits, labels) == "cpu":
        return _ref.softmax_xent_fwd_ref(logits, labels)
    nll = torch.empty((b,), device=logits.device, dtype=torch.float32)
    lse = torch.empty((b,), device=logits.device, dtype=torch.float32)
    mean = torch.empty((), device=logits.device, dtype=torch.float32)
    _build.extension().xent_fwd(logits, labels, nll, lse, mean)
    softmax_xent_fwd.launches += 1
    return nll, lse, mean


def softmax_xent_dlogits(logits: torch.Tensor, labels: torch.Tensor,
                         lse: torch.Tensor, scale: torch.Tensor | None = None,
                         *, g: torch.Tensor | None = None) -> torch.Tensor:
    """dlogits = (softmax(logits) − onehot(labels)) · s[:, None] in the
    logits' dtype, with s = ``scale`` ((B,) fp32, per row; stride 0 is
    fine) or s = ``g`` / B for the loss cotangent ``g`` (0-d fp32), the
    gradient of the batch-mean loss.  logits: (B, C) fp32 or bf16;
    labels: (B,) int32; lse: (B,) fp32."""
    kernel = "softmax_xent_dlogits"
    b, c = _logits(kernel, logits)
    check_arg(kernel, "labels", labels, (b,), torch.int32)
    check_arg(kernel, "lse", lse, (b,))
    if (scale is None) == (g is None):
        raise ValueError(f"{kernel}: pass exactly one of scale and g")
    if scale is not None:
        if scale.dtype != torch.float32 or tuple(scale.shape) != (b,):
            raise ValueError(f"{kernel}: scale must be ({b},) float32, got "
                             f"{tuple(scale.shape)} {scale.dtype}")
        if scale.stride(0) not in (0, 1) and b > 1:
            raise ValueError(f"{kernel}: scale must have stride 0 or 1")
        factor, stride, div = scale, scale.stride(0) if b > 1 else 0, 1
    else:
        if g.dtype != torch.float32 or g.dim() != 0:
            raise ValueError(f"{kernel}: g must be a 0-d float32 tensor, got "
                             f"{tuple(g.shape)} {g.dtype}")
        factor, stride, div = g, 0, b
    if device_type(kernel, logits, labels, lse, factor) == "cpu":
        return _ref.softmax_xent_dlogits_ref(logits, labels, lse, scale, g=g)
    dx = torch.empty((b, c), device=logits.device, dtype=logits.dtype)
    _build.extension().xent_dlogits(logits, labels, lse, factor, stride, div,
                                    dx)
    softmax_xent_dlogits.launches += 1
    return dx


softmax_xent_fwd.launches = 0
softmax_xent_dlogits.launches = 0
