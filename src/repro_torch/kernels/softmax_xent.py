"""Wrappers of the two softmax cross-entropy kernels
(``csrc/softmax_xent.cu``): the FCNN output period and the LM's token
loss at (B·L, padded vocabulary).

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
``fwd_plan`` picks K4's kernel and ``vector_loads`` both kernels'
vector width from (B, C) and the logits' alignment; the CUDA launchers
size the grids from those flags (see the CUDA source).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fcnn_layer import check_arg, device_type

__all__ = ["softmax_xent_fwd", "softmax_xent_dlogits", "fwd_plan",
           "vector_loads", "XentPlan"]

LOGIT_DTYPES = (torch.float32, torch.bfloat16)

# csrc/softmax_xent.cu: the lane kernel's largest (C, B), the rows
# kernel's warps a block and the C from which a row takes a whole block
LANE_MAX_C, LANE_MAX_B = 16, 256
ROW_WARPS = 8
BLOCK_ROW_MIN_C = 4096


class XentPlan(NamedTuple):
    """K4's launch flags: ``warps_per_row`` 0 is the one-block lane kernel
    (a thread a row, the mean in the same block); 1 or 8 the rows kernel
    (a warp or a block a row, 16-byte loads where ``vec``) on a grid, then
    the one-block mean kernel."""
    warps_per_row: int
    vec: bool


def vector_loads(c: int, element_size: int = 4, aligned: bool = True) -> bool:
    """Whether K4's rows kernel and K5 move (B, C) logits of
    ``element_size`` bytes in 16-byte vectors: where C is a multiple of
    the vector and the data is ``aligned`` to 16 bytes."""
    return aligned and c % (16 // element_size) == 0


def fwd_plan(b: int, c: int, element_size: int = 4,
             aligned: bool = True) -> XentPlan:
    """K4's kernel for (B, C) logits of ``element_size`` bytes, ``aligned``
    if their data starts on a 16-byte boundary."""
    if c <= LANE_MAX_C and b <= LANE_MAX_B:
        return XentPlan(0, False)
    return XentPlan(ROW_WARPS if c >= BLOCK_ROW_MIN_C else 1,
                    vector_loads(c, element_size, aligned))


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
    plan = fwd_plan(b, c, logits.element_size(), logits.data_ptr() % 16 == 0)
    _build.extension().xent_fwd(logits, labels, nll, lse, mean,
                                plan.warps_per_row, int(plan.vec))
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
    vec = vector_loads(c, logits.element_size(), logits.data_ptr() % 16 == 0)
    _build.extension().xent_dlogits(logits, labels, lse, factor, stride, div,
                                    dx, int(vec))
    softmax_xent_dlogits.launches += 1
    return dx


softmax_xent_fwd.launches = 0
softmax_xent_dlogits.launches = 0
