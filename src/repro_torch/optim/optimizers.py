"""Adam with the reference's contract (``repro/optim/optimizers.py``):
``init(params) -> state`` and ``update(grads, state, params, step) ->
(params, state)``, fp32 moments, bias correction at step+1, and eps
outside ``sqrt(v·vhat)``.  The schedule and the bias corrections are
computed in fp32 on the parameters' device, so a step never syncs with
the host; nor do ``global_norm`` and ``clip_by_global_norm``.

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


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: _f32(lr))

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
            u = (m * mhat_scale) / (torch.sqrt(v * vhat_scale) + eps)
            p.sub_((eta * u).to(p.dtype))
        return params, state

    return Optimizer(init, update)


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
