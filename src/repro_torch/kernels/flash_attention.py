"""Wrappers of the flash-attention kernel (``csrc/flash_attention.cu``),
the LM's self- and cross-attention, and of its backward
(``csrc/flash_attention_bwd.cu``), which the LM training step runs.

  flash_attention      softmax(q kᵀ/√D, causal or not) v, and with
                       ``lse=True`` each row's log-sum-exp      replaces repro/kernels/flash_attention.py:72
  flash_attention_bwd  dq, dk, dv from q, k, v, o, dO and lse   counterpart of _sdpa_chunked_bwd (repro/models/layers.py)

A causal call may take a sliding window: ``window`` > 0 keeps key k for
query q where q - window < k <= q, the reference model's mask for a
prefill longer than ``attn_window`` (``repro/models/layers.py``
``attention``); the kernel skips the key tiles below the window, so a
windowed prefill costs O(S·window).  0 is no window.

q is (B, H, Sq, D) and k, v are (B, KV, Sk, D) with H a multiple of KV:
grouped-query attention, query head h reading KV head h // (H // KV), as
the model's ``_sdpa`` groups them (KV = H is multi-head attention).  The
kernel indexes the KV head itself, so K and V are never repeated or
copied per group.  Keys of another length than the queries are
cross-attention (the encoder-decoder's decoder over the encoder's
frames), which is not causal: causal attention with Sq != Sk has no
caller in the reference and is refused on either device, the plain
version included (``ref.check_causal_lengths``).  Checks device, dtype (fp32 or bf16, the same for q, k
and v), shapes and strides, then picks by the tensors' device: on CUDA it allocates the
output in q's memory layout, launches the kernel on the current stream
and adds one to ``launches``; on the CPU it runs the plain version from
``ref.py``; on the meta device it returns the empty output and reports
the launch to the dry-run (``cost.report``).  The kernel reads q, k and
v through their (batch, head, seq) strides, so transposed views of the model's (B, S, H, D) projections go
in without a copy.  In bf16 the kernel loads q, k and v with the Tensor
Memory Accelerator, which needs a 16-byte aligned base and (batch, head,
seq) strides of a multiple of 16 bytes: other bf16 views are refused on
either device, before the dispatch, and never rerouted.  The raw
wrapper refuses inputs that require grad rather than silently detaching
them: ``ops.flash_attention`` is the differentiable op, an autograd
function whose forward saves ``lse`` and whose backward calls
``flash_attention_bwd``.

``flash_attention_bwd`` takes the forward's checks, dO of q's shape and
o's too, lse (B, H, Sq) fp32, and picks by device as the forward does:
CPU, the plain ``ref.flash_attention_bwd_ref``; meta, empty gradients and
``cost.flash_attention_bwd``; CUDA, the three kernels of
``flash_attention_bwd.cu`` (delta, dK/dV, dQ) with one count in
``flash_attention_bwd.launches``.  The gradients leave in q's, k's and
v's dtypes and memory layouts.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fcnn_layer import KernelLimitError, device_type

__all__ = ["flash_attention", "flash_attention_bwd", "FLOAT_DTYPES",
           "check_float_args", "check_tma_aligned", "tma_aligned"]

FLOAT_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
_INT32_MAX = 2**31 - 1


def check_float_args(kernel: str, **tensors: torch.Tensor) -> torch.dtype:
    """Raise unless every tensor is fp32 or bf16 (all of one dtype), has a
    unit last stride and needs no gradient; return the dtype."""
    dtypes = {t.dtype for t in tensors.values()}
    for name, t in tensors.items():
        if t.dtype not in FLOAT_DTYPES:
            raise TypeError(f"{kernel}: {name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dim() and t.stride(-1) != 1 and t.shape[-1] != 1:
            raise ValueError(f"{kernel}: {name} needs a unit stride in its "
                             f"last dimension, got strides {t.stride()}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{kernel} is forward-only (the reference "
                               f"kernel has no VJP); {name} requires grad")
        if t.numel() > _INT32_MAX:
            raise KernelLimitError(f"{kernel}: {name} has {t.numel()} "
                                   f"elements; at most {_INT32_MAX} "
                                   f"supported")
    if len(dtypes) != 1:
        raise TypeError(f"{kernel}: mixed dtypes {sorted(map(str, dtypes))}")
    return dtypes.pop()


def tma_aligned(t: torch.Tensor) -> bool:
    """Whether ``t``'s base address and its strides in every dimension but
    the last (of size > 1) are multiples of 16 bytes (a meta tensor has no
    address: its strides alone count)."""
    e = t.element_size()
    return ((t.is_meta or t.data_ptr() % 16 == 0)
            and all(t.shape[d] == 1 or t.stride(d) * e % 16 == 0
                    for d in range(t.dim() - 1)))


def check_tma_aligned(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise unless each tensor is ``tma_aligned``."""
    for name, t in tensors.items():
        if not tma_aligned(t):
            raise ValueError(
                f"{kernel}: {t.dtype} {name} must be 16-byte aligned, with "
                f"strides of a multiple of 16 bytes (TMA); got address "
                f"{t.data_ptr() % 16} mod 16 and strides {t.stride()}")


def _check_shapes(kernel: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, causal: bool, window: int) -> int:
    """Raise unless q (B, H, Sq, D) and k, v (B, KV, Sk, D) are shapes and a
    mask the kernels take; return ``window`` as an int."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{kernel}: {name} must be (B, H, S, D), "
                             f"got {t.dim()}-D")
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if (k.shape != v.shape or (k.shape[0], k.shape[3]) != (b, d)
            or kv < 1 or h % kv):
        raise ValueError(f"{kernel}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: k and v must "
                         f"be (B, KV, Sk, D) with H % KV == 0 (GQA)")
    if min(b, h, s, sk, d) < 1 or d > MAX_HEAD_DIM or b * h > 65535:
        error = ValueError if min(b, h, s, sk, d) < 1 else KernelLimitError
        raise error(f"{kernel}: q {tuple(q.shape)}, k "
                    f"{tuple(k.shape)} outside B·H <= 65535, Sq, Sk >= 1, "
                    f"1 <= D <= {MAX_HEAD_DIM}")
    window = int(window)
    if window > _INT32_MAX:
        raise KernelLimitError(f"{kernel}: window {window} > {_INT32_MAX}")
    _ref.check_causal_lengths(s, sk, causal, window)
    return window


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, *,
                    lse: bool = False
                    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """q: (B, H, Sq, D), k, v: (B, KV, Sk, D), H % KV == 0, any Sq, Sk >= 1
    (Sk = Sq where causal), D <= 128 -> (B, H, Sq, D) in q's dtype;
    ``window`` >= 0, and > 0 only where causal.  With ``lse`` -> (o, lse),
    lse (B, H, Sq) fp32 the log-sum-exp of each row's scaled scores."""
    window = _check_shapes("flash_attention", q, k, v, causal, window)
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if check_float_args("flash_attention", q=q, k=k, v=v) == torch.bfloat16:
        check_tma_aligned("flash_attention", q=q, k=k, v=v)
    dev = device_type("flash_attention", q, k, v)
    if dev == "cpu":
        if lse:
            return _ref.flash_attention_lse_ref(q, k, v, causal, window)
        return _ref.flash_attention_ref(q, k, v, causal, window)
    out = torch.empty_like(q)
    row_lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
               if lse else None)
    if dev == "meta":
        cost.report("flash_attention", cost.flash_attention(
            b, h, kv, s, sk, d, q.element_size(), causal, window))
    elif lse:
        _build.extension().flash_attention_lse(q, k, v, out, row_lse,
                                               bool(causal), window)
        flash_attention.launches += 1
    else:
        _build.extension().flash_attention(q, k, v, out, bool(causal), window)
        flash_attention.launches += 1
    return (out, row_lse) if lse else out


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, causal: bool = True,
                        window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal, window)`` for the
    cotangent ``dout``, from its output ``o`` and ``lse``: q, o, dout (B,
    H, Sq, D), k, v (B, KV, Sk, D), lse (B, H, Sq) fp32; the gradients in
    q's, k's and v's dtypes and layouts."""
    kernel = "flash_attention_bwd"
    window = _check_shapes(kernel, q, k, v, causal, window)
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("dout", dout)):
        if t.shape != q.shape:
            raise ValueError(f"{kernel}: {name} {tuple(t.shape)} must have "
                             f"q's shape {tuple(q.shape)}")
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"{kernel}: lse must be ({b}, {h}, {s}) float32 "
                         f"and contiguous, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    dtype = check_float_args(kernel, q=q, k=k, v=v, o=o, dout=dout)
    if dtype == torch.bfloat16:
        check_tma_aligned(kernel, q=q, k=k, v=v, dout=dout)
    dev = device_type(kernel, q, k, v, o, dout, lse)
    if dev == "cpu":
        return _ref.flash_attention_bwd_ref(q, k, v, o, dout, lse, causal,
                                            window)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if dev == "meta":
        cost.report(kernel, cost.flash_attention_bwd(
            b, h, kv, s, sk, d, q.element_size(), causal, window))
    else:
        _build.extension().flash_attention_bwd(q, k, v, o, dout, lse, delta,
                                               dq, dk, dv, bool(causal),
                                               window)
        flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
