"""SGD, momentum (plain and Nesterov), Adam and AdamW with the reference's
contract (``repro/optim/optimizers.py``): ``init(params) -> state`` and
``update(grads, state, params, step) -> (params, state)``, moments in
fp32 whatever the parameters' dtype, each new parameter computed in fp32
and rounded once to its dtype; Adam and AdamW share one core (bias
correction at step+1, eps outside ``sqrt(v·vhat)``, AdamW's decay added
to the update ``u`` and scaled by the rate with it).  The schedule and
the bias corrections are computed in fp32 on the parameters' device, so
a step never syncs with the host; nor do ``global_norm`` and
``clip_by_global_norm``.

Unlike the reference, whose arrays are immutable, ``update`` writes the
new moments and parameters in place (under ``torch.no_grad``) and
returns the same objects: that saves a copy of the model and its
moments per step.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.optim.schedules import _f32

Params = Any


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params, Any], tuple[Params, Any]]
    # update(grads, state, params, step) -> (params, state), in place


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    raise TypeError(f"unsupported parameter tree node {type(tree)}")


def _map_tree(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return [_map_tree(fn, v) for v in tree]


def _zeros_like_tree(tree):
    return _map_tree(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                           device=t.device), tree)


def _rate(lr) -> Callable:
    return lr if callable(lr) else (lambda _: _f32(lr))


def _apply(p: torch.Tensor, eta: torch.Tensor, u: torch.Tensor) -> None:
    """p <- (p - eta·u) in fp32, rounded once to p's dtype, in place (for
    an fp32 ``p`` that is ``p.sub_(eta * u)``, bit for bit)."""
    u.mul_(eta)
    if p.dtype == torch.float32:
        p.sub_(u)
    else:
        p.copy_(p.float().sub_(u))


def sgd(lr) -> Optimizer:
    lr_fn = _rate(lr)

    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params, step):
        p_leaves = _leaves(params)
        eta = lr_fn(_f32(step).to(p_leaves[0].device))
        for p, g in zip(p_leaves, _leaves(grads)):
            _apply(p, eta, g.to(torch.float32, copy=True))
        return params, state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    lr_fn = _rate(lr)

    def init(params):
        return {"m": _zeros_like_tree(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        p_leaves = _leaves(params)
        eta = lr_fn(_f32(step).to(p_leaves[0].device))
        for p, g, m in zip(p_leaves, _leaves(grads), _leaves(state["m"])):
            g = g.to(torch.float32)
            m.mul_(beta).add_(g)
            u = m * beta + g if nesterov else m.clone()
            _apply(p, eta, u)
        return params, state

    return Optimizer(init, update)


def _adam_core(lr_fn, b1: float, b2: float, eps: float,
               weight_decay: float) -> Optimizer:
    def init(params):
        return {"m": _zeros_like_tree(params), "v": _zeros_like_tree(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        p_leaves = _leaves(params)
        device = p_leaves[0].device
        step = _f32(step).to(device) + 1.0
        eta = lr_fn(step)
        mhat_scale = 1.0 / (1.0 - torch.pow(b1, step))
        vhat_scale = 1.0 / (1.0 - torch.pow(b2, step))
        for p, g, m, v in zip(p_leaves, _leaves(grads), _leaves(state["m"]),
                              _leaves(state["v"])):
            g = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            del g
            # u = (m·mhat) / (sqrt(v·vhat) + eps) [+ wd·p], in place
            u = m * mhat_scale
            u.div_(torch.sqrt_(v * vhat_scale).add_(eps))
            if weight_decay:
                u.add_(weight_decay * p.float())
            _apply(p, eta, u)
        return params, state

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    return _adam_core(_rate(lr), b1, b2, eps, 0.0)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    return _adam_core(_rate(lr), b1, b2, eps, weight_decay)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, in fp32: a 0-d tensor on the leaves'
    device."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in _leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-12)), norm), as the
    reference's ``clip_by_global_norm``; each leaf keeps its dtype."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return _map_tree(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                     grads), norm
