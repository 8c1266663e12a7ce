"""Gradient accumulation and int8 gradient compression, counterpart of
the reference ``repro/parallel/gradsync.py``.

* ``value_and_grad`` — ``jax.value_and_grad`` for a loss of a parameter
  tree: the loss and a tree of gradients (zeros for a leaf the loss does
  not reach), computed on detached views of the leaves, so the caller's
  tensors need no ``requires_grad``.
* ``accumulate_grads`` — microbatched accumulation: the mean loss and the
  mean gradients over the leading axis of ``microbatches``, accumulated
  in each parameter's dtype unless ``acc_dtype`` says otherwise.
* int8 compression with an error-feedback residual — per-tensor
  symmetric quantization (``scale = max|g|/127 + 1e-12``, codes rounded
  half to even and clipped to ±127); the residual, fp32, carries the
  quantization error into the next step.  With one card nothing crosses
  a network: the step applies it to keep the reference's arithmetic.
  ``compress_grads_ef`` writes the new residual into ``residual`` in
  place (one fp32 copy of the model less at full width) and returns it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.tree import tree_map as _map

Params = Any

__all__ = ["value_and_grad", "accumulate_grads", "quantize_int8",
           "dequantize_int8", "compress_grads_ef", "init_residual"]


def value_and_grad(loss_fn: Callable) -> Callable:
    """(params, batch) -> (loss, grads) of ``loss_fn(params, batch)``: the
    loss detached, the gradients a tree like ``params``."""
    def fn(params: Params, batch: Any):
        leaves: list[torch.Tensor] = []

        def leaf(p: torch.Tensor) -> torch.Tensor:
            leaves.append(p.detach().requires_grad_(True))
            return leaves[-1]

        tree = _map(leaf, params)
        with torch.enable_grad():
            loss = loss_fn(tree, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, grads)])
        return loss.detach(), _map(lambda _: next(it), params)
    return fn


def accumulate_grads(loss_fn: Callable, params: Params, microbatches: dict,
                     acc_dtype: torch.dtype | None = None
                     ) -> tuple[torch.Tensor, Params]:
    """microbatches: a dict of tensors with a leading (n_micro, ...) axis.
    Returns (mean loss, mean grads): each microbatch's loss summed in fp32
    and its gradients added to accumulators in the parameters' dtypes, or
    in ``acc_dtype`` (the grads are then returned in it), both divided by
    n_micro at the end, as the reference's scan does."""
    grad_fn = value_and_grad(loss_fn)
    n = next(iter(microbatches.values())).shape[0]
    loss_acc = None
    grad_acc = _map(lambda p: torch.zeros(p.shape, dtype=acc_dtype or p.dtype,
                                          device=p.device), params)
    for i in range(n):
        loss, grads = grad_fn(params, {k: v[i] for k, v in
                                       microbatches.items()})
        loss_acc = loss if loss_acc is None else loss_acc + loss
        _map(lambda a, g: a.add_(g.to(a.dtype)), grad_acc, grads)
        del grads
    return loss_acc / n, _map(lambda g: g / n, grad_acc)


# ----------------------------------------------------------------- int8 EF

def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes int8, scale 0-d) with scale = max|g|/127 + 1e-12 and codes
    round(g/scale) (half to even) clipped to ±127."""
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads_ef(grads: Params, residual: Params
                      ) -> tuple[Params, Params]:
    """Error-feedback int8 compression of every leaf: the target g + r
    (fp32) is quantized and dequantized; returns (the dequantized grads,
    fp32, which the optimizer consumes, and the residual target − deq,
    written into ``residual`` in place)."""
    def one(g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        target = g.to(torch.float32) + r
        deq = dequantize_int8(*quantize_int8(target))
        torch.sub(target, deq, out=r)
        return deq

    return _map(one, grads, residual), residual


def init_residual(params: Params) -> Params:
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
