"""Adam with the reference's contract (``repro/optim/optimizers.py``):
``init(params) -> state`` and ``update(grads, state, params, step) ->
(params, state)``, fp32 moments, bias correction at step+1, and eps
outside ``sqrt(v·vhat)``.  The schedule and the bias corrections are
computed in fp32 on the parameters' device, so a step never syncs with
the host.

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


def _zeros_like_tree(tree):
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return [_zeros_like_tree(v) for v in tree]


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
