"""The ops the models call over the kernels, and their dispatch.

``fcnn_layer`` and ``softmax_xent`` (differentiable) are what the FCNN
calls, and ``softmax_xent`` the LM loss too; ``flash_attention``
(differentiable: K6 forward, K6's backward kernels for the gradients) is
the LM's attention in prefill and in training; ``ssd_chunk``
(differentiable: K7 forward, its backward kernels for the gradients) is
the Mamba2 SSD's intra-chunk term in prefill and in training.
The mode:

  * ``None`` (default) — the fused path: ``_FusedFCNN`` / ``_FusedXent``
    / ``_FlashAttention``, whose forward and backward call the kernel
    wrappers.  A wrapper
    launches its CUDA kernel for CUDA tensors and runs its plain version
    for CPU tensors, so the tensors' device picks the path.
  * ``"cuda"`` — the fused path, and raise unless the tensors are on CUDA
    (or on the meta device, where the dry-run follows the card's path).
  * ``"ref"`` — the plain versions of ``ref.py`` under ordinary autograd,
    for comparisons only.

No mode falls back to another: a failed build or launch raises.

Autograd wiring (counterpart of the reference's ``jax.custom_vjp``s):
``_FusedFCNN`` saves ``(x, w, b, y)`` — b only for the db dtype, never a
pre-activation — and its backward runs the dgrad and wgrad kernels, then
casts dX, dW and db to the dtypes of x, w and b as the reference's VJP
does (the kernels give dX in dy's dtype, dW in x's and db in dy's: in a
bf16 network fed fp32 data, dW leaves K3 in fp32 and is rounded to bf16
here, as in the reference);
``_FusedXent`` returns K4's batch mean as the loss, saves ``(logits,
labels, lse)`` and hands the loss cotangent ``g`` to the dlogits kernel,
which forms g/B itself: no PyTorch operation runs around the two
kernels.  ``_MaskedXent`` (the LM loss with a token mask) takes the
masked mean Σ nll·mask / max(Σ mask, 1) of K4's per-row nll and hands
K5 the per-row factor g·mask / max(Σ mask, 1).  Labels and masks get no
gradient.  ``_FlashAttention`` (where q, k or v requires grad) runs K6
with its log-sum-exp, saves ``(q, k, v, o, lse)`` and hands its backward
to ``flash_attention_bwd``; attention that needs no gradient (serving)
calls K6 alone, without the lse.  ``_SsdChunk`` (where x, dt_a, b or c
requires grad) runs K7, saves ``(x, dt_a, b, c)`` and nothing of (Q, Q)
size, and hands the three cotangents (None where autograd has none:
zeros are not made) to ``ssd_chunk_bwd``; the SSD that needs no gradient
(serving) calls K7 alone.

The head broadcast of B and C lies inside ``ssd_chunk``: it takes them
group-shaped (BC, Q, G, N), G dividing H, and hands the kernels a
(BC, Q, H, N) view of them, stride 0 across the heads where G = 1 (the
models' ``ssm_groups``).  So ``_SsdChunk`` returns dB and dC group-shaped,
each group's heads summed by the backward kernels in fp32 in a fixed
order and rounded once.  Outside, the expand's backward would sum
per-head gradients already rounded to bf16, in an order autograd picks,
and the kernels would write H / G times the bytes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_attention,
    flash_attention_bwd as _flash_attention_bwd,
    tma_aligned,
)
from repro_torch.kernels.fcnn_layer import (
    fcnn_layer as _fcnn_fwd,
    fcnn_layer_dgrad as _fcnn_dgrad,
    fcnn_layer_wgrad as _fcnn_wgrad,
)
from repro_torch.kernels.softmax_xent import (
    softmax_xent_dlogits as _xent_dlogits,
    softmax_xent_fwd as _xent_fwd,
)
from repro_torch.kernels.ssd_scan import (
    ssd_chunk as _ssd_chunk,
    ssd_chunk_bwd as _ssd_chunk_bwd,
)

__all__ = ["fcnn_layer", "softmax_xent", "flash_attention", "ssd_chunk",
           "heads_of_groups", "KERNELS", "MODES", "launch_counts",
           "reset_launches", "resolve_mode"]

MODES = (None, "cuda", "ref")

# every kernel wrapper, by the name its launches report
KERNELS = {
    "fcnn_layer": _fcnn_fwd,
    "fcnn_layer_dgrad": _fcnn_dgrad,
    "fcnn_layer_wgrad": _fcnn_wgrad,
    "softmax_xent_fwd": _xent_fwd,
    "softmax_xent_dlogits": _xent_dlogits,
    "flash_attention": _flash_attention,
    "flash_attention_bwd": _flash_attention_bwd,
    "ssd_chunk": _ssd_chunk,
    "ssd_chunk_bwd": _ssd_chunk_bwd,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "tc_launches"):
            fn.tc_launches = 0


def resolve_mode(mode: str | None, *tensors: torch.Tensor) -> str | None:
    """``mode`` after checking it is one of MODES and, for ``"cuda"``,
    that every tensor lies on a CUDA device (or on meta)."""
    if mode not in MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; one of {MODES}")
    if mode == "cuda" and not all(t.is_cuda or t.is_meta for t in tensors):
        raise ValueError("mode='cuda' needs CUDA tensors")
    return mode


class _FusedFCNN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, activation):
        y = _fcnn_fwd(x, w, b, activation)
        ctx.save_for_backward(x, w, b, y)
        ctx.activation = activation
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, b, y = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _fcnn_dgrad(dy, y, w, ctx.activation).to(x.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = _fcnn_wgrad(x, dy, y, ctx.activation)
            dw, db = dw.to(w.dtype), db.to(b.dtype)
        return dx, dw, db, None


class _FusedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        _, lse, mean = _xent_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return mean

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        # the mean's 1/B and the cotangent fold into the kernel's g/B
        return _xent_dlogits(logits, labels, lse, g=g), None  # labels: no grad


class _MaskedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mask):
        nll, lse, _ = _xent_fwd(logits, labels)
        mask = mask.float()
        den = torch.clamp(mask.sum(), min=1.0)
        ctx.save_for_backward(logits, labels, lse, mask / den)
        return (nll * mask).sum() / den

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse, weight = ctx.saved_tensors
        return (_xent_dlogits(logits, labels, lse, g * weight), None, None)


def _unit_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where K6's backward can read it (a unit last stride,
    ``tma_aligned``), else a contiguous copy: the cotangent autograd hands
    over may be any view."""
    return t if t.stride(-1) == 1 and tma_aligned(t) else t.contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = _flash_attention(q, k, v, causal, window, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_attention_bwd(q, k, v, o, _unit_rows(do), lse,
                                          ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def heads_of_groups(t: torch.Tensor, h: int) -> torch.Tensor:
    """B or C (…, G, N) as (…, H, N), each group repeated over its H / G
    consecutive heads: a view, stride 0 across the heads where G = 1 (and
    ``t`` itself where G = H); a tensor whose G does not divide H is
    returned as it is, for the wrapper to refuse."""
    if t.dim() < 2 or t.shape[-2] == h or h % t.shape[-2]:
        return t
    *lead, g, n = t.shape
    return t[..., :, None, :].expand(*lead, g, h // g, n).reshape(
        *lead, h, n)


class _SsdChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt_a, b, c):
        h = x.shape[2]
        out = _ssd_chunk(x, dt_a, heads_of_groups(b, h),
                         heads_of_groups(c, h))
        ctx.save_for_backward(x, dt_a, b, c)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, dy, dstate, ddecay):
        x, dt_a, b, c = ctx.saved_tensors
        h = x.shape[2]
        if dy is not None and dy.stride(-1) != 1:
            dy = dy.contiguous()
        return _ssd_chunk_bwd(x, dt_a, heads_of_groups(b, h),
                              heads_of_groups(c, h), dy, dstate, ddecay,
                              b.shape[2])


def fcnn_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               activation: str = "sigmoid", *,
               mode: str | None = None) -> torch.Tensor:
    """act(x @ w + b), differentiable in x, w and b."""
    if resolve_mode(mode, x, w, b) == "ref":
        return _ref.fcnn_layer_ref(x, w, b, activation)
    return _FusedFCNN.apply(x, w, b, activation)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None, *,
                 mode: str | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy (fp32).  logits: (B, C) fp32 or bf16;
    labels: (B,) int32; with ``mask`` (B,) (bool or float), the masked
    mean Σ nll·mask / max(Σ mask, 1)."""
    if resolve_mode(mode, logits, labels) == "ref":
        nll, _, mean = _ref.softmax_xent_fwd_ref(logits, labels)
        if mask is None:
            return mean
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if mask is None:
        return _FusedXent.apply(logits, labels)
    return _MaskedXent.apply(logits, labels, mask)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, *, window: int = 0,
                    mode: str | None = None) -> torch.Tensor:
    """softmax(q kᵀ/√D) v.  q: (B, H, Sq, D), k, v: (B, KV, Sk, D) with
    H % KV == 0 (GQA) and Sk = Sq where causal -> (B, H, Sq, D); a causal
    call with ``window`` > 0 keeps key k for query q where
    q - window < k <= q.  Differentiable in q, k and v."""
    if resolve_mode(mode, q, k, v) == "ref":
        return _ref.flash_attention_ref(q, k, v, causal, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _flash_attention(q, k, v, causal, window)


def ssd_chunk(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, *, mode: str | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD over a batch of chunks.  x (BC, Q, H, P), dt_a
    (BC, Q, H), b, c (BC, Q, G, N), each of G groups broadcast to H / G
    consecutive heads (G = H: one a head) -> (y_diag, state (BC, H, P, N),
    decay (BC, Q, H)).  Differentiable in x, dt_a, b and c."""
    h = x.shape[2] if x.dim() == 4 else 0
    if resolve_mode(mode, x, dt_a, b, c) == "ref":
        return _ref.ssd_chunk_ref(x, dt_a, heads_of_groups(b, h),
                                  heads_of_groups(c, h))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt_a, b, c)):
        return _SsdChunk.apply(x, dt_a, b, c)
    return _ssd_chunk(x, dt_a, heads_of_groups(b, h), heads_of_groups(c, h))
