"""Wrappers of the three FCNN period kernels.

  fcnn_layer        act(x @ w + b)                 replaces repro/kernels/fcnn_layer.py:142
  fcnn_layer_dgrad  dX = (dY ⊙ A'(Y)) @ Wᵀ         replaces repro/kernels/fcnn_layer.py:208
  fcnn_layer_wgrad  (Xᵀ @ dZ, Σ_rows dZ)           replaces repro/kernels/fcnn_layer.py:292

K1 and K3 are ``csrc/fcnn_layer.cu``; K2 is ``csrc/fcnn_dgrad.cu``, whose
contraction is split over the blocks of a thread-block cluster as
``dgrad_plan`` picks from the shape.

Each wrapper checks dtype (fp32 only), shape and contiguity, then picks
by the tensors' device: on CUDA it allocates the outputs, launches the
kernel on the current stream and adds one to its ``launches`` counter;
on the CPU it runs the plain version from ``ref.py``.  There is no other
path: a CUDA tensor never reaches the plain version, and a failed build
or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["fcnn_layer", "fcnn_layer_dgrad", "fcnn_layer_wgrad",
           "dgrad_plan"]

# codes of csrc/fcnn_act.cuh's Act enum
ACT_CODES = {"none": 0, "sigmoid": 1, "relu": 2, "tanh": 3}

_INT32_MAX = 2**31 - 1

# csrc/fcnn_dgrad.cu: dX tiles of 64 x 32 and 128 threads, up to two
# blocks on each of the H100's 132 SMs, at most 8 blocks to a cluster (the
# portable size), contraction slices of 16 or 32
DGRAD_TILE = (64, 32)
DGRAD_MAX_SPLIT = 8
DGRAD_BLOCK_SLOTS = 2 * 132


def dgrad_plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(split, slice) of K2 for dX (m, k) over the contraction n: slices of
    32 where n >= 64, else 16; the split is the largest power of two up to
    8 that keeps the grid within the card's block slots and gives every
    block of a cluster at least two slices."""
    slice_ = 32 if n >= 64 else 16
    tiles = -(-m // DGRAD_TILE[0]) * -(-k // DGRAD_TILE[1])
    slices = -(-n // slice_)
    split = 1
    while (split < DGRAD_MAX_SPLIT and tiles * split * 2 <= DGRAD_BLOCK_SLOTS
           and slices >= 2 * split * 2):
        split *= 2
    return split, slice_


def act_code(activation: str) -> int:
    try:
        return ACT_CODES[activation]
    except KeyError:
        raise ValueError(f"unknown activation {activation!r}") from None


def device_type(kernel: str, *tensors: torch.Tensor) -> str:
    """``"cuda"`` or ``"cpu"``: where a kernel call's tensors all lie."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: tensors lie on several devices "
                         f"{sorted(str(d) for d in devices)}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{kernel}: unsupported device {dev}")
    return dev.type


def check_arg(kernel: str, name: str, t: torch.Tensor, shape: tuple,
              dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` has this shape and dtype and is contiguous,
    with every size in 1..2**31-1 (the kernels index with 32-bit ints)."""
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if t.numel() == 0 or t.numel() > _INT32_MAX:
        raise ValueError(f"{kernel}: {name} has {t.numel()} elements; "
                         f"1..{_INT32_MAX} supported")


def _matrix(kernel: str, name: str, t: torch.Tensor) -> tuple[int, int]:
    if t.dim() != 2:
        raise ValueError(f"{kernel}: {name} must be 2-D, got {t.dim()}-D")
    return t.shape[0], t.shape[1]


def fcnn_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               activation: str = "sigmoid") -> torch.Tensor:
    """act(x @ w + b).  x: (M, K); w: (K, N); b: (N,) -> (M, N) fp32."""
    act = act_code(activation)
    m, k = _matrix("fcnn_layer", "x", x)
    n = _matrix("fcnn_layer", "w", w)[1]
    check_arg("fcnn_layer", "x", x, (m, k))
    check_arg("fcnn_layer", "w", w, (k, n))
    check_arg("fcnn_layer", "b", b, (n,))
    if device_type("fcnn_layer", x, w, b) == "cpu":
        return _ref.fcnn_layer_ref(x, w, b, activation)
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    _build.extension().fcnn_fwd(x, w, b, out, act)
    fcnn_layer.launches += 1
    return out


def fcnn_layer_dgrad(dy: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                     activation: str = "sigmoid") -> torch.Tensor:
    """dX = (dY ⊙ A'(Y)) @ Wᵀ.  dy, y: (M, N); w: (K, N) -> (M, K) fp32."""
    act = act_code(activation)
    m, n = _matrix("fcnn_layer_dgrad", "dy", dy)
    k = _matrix("fcnn_layer_dgrad", "w", w)[0]
    check_arg("fcnn_layer_dgrad", "dy", dy, (m, n))
    check_arg("fcnn_layer_dgrad", "y", y, (m, n))
    check_arg("fcnn_layer_dgrad", "w", w, (k, n))
    if device_type("fcnn_layer_dgrad", dy, y, w) == "cpu":
        return _ref.fcnn_layer_dgrad_ref(dy, y, w, activation)
    dx = torch.empty((m, k), device=dy.device, dtype=torch.float32)
    _build.extension().fcnn_dgrad(dy, y, w, dx, act, *dgrad_plan(m, k, n))
    fcnn_layer_dgrad.launches += 1
    return dx


def fcnn_layer_wgrad(x: torch.Tensor, dy: torch.Tensor, y: torch.Tensor,
                     activation: str = "sigmoid"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dW, db) = (Xᵀ @ dZ, Σ_rows dZ) with dZ = dY ⊙ A'(Y).
    x: (M, K); dy, y: (M, N) -> ((K, N), (N,)) fp32."""
    act = act_code(activation)
    m, k = _matrix("fcnn_layer_wgrad", "x", x)
    n = _matrix("fcnn_layer_wgrad", "dy", dy)[1]
    check_arg("fcnn_layer_wgrad", "x", x, (m, k))
    check_arg("fcnn_layer_wgrad", "dy", dy, (m, n))
    check_arg("fcnn_layer_wgrad", "y", y, (m, n))
    if device_type("fcnn_layer_wgrad", x, dy, y) == "cpu":
        return _ref.fcnn_layer_wgrad_ref(x, dy, y, activation)
    dw = torch.empty((k, n), device=x.device, dtype=torch.float32)
    db = torch.empty((n,), device=x.device, dtype=torch.float32)
    _build.extension().fcnn_wgrad(x, dy, y, dw, db, act)
    fcnn_layer_wgrad.launches += 1
    return dw, db


fcnn_layer.launches = 0
fcnn_layer_dgrad.launches = 0
fcnn_layer_wgrad.launches = 0
