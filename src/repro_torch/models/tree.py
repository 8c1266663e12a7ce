"""Parameter trees of the LM families: nested dicts of tensors with the
reference's names and layouts, the per-layer leaves stacked on a leading
layer axis (what ``jax.vmap`` of a block's init makes in the reference).

``init_stacked`` draws the layers one at a time straight into stacked
tensors allocated once, so a model's peak during init is its parameters
plus one layer in flight (``torch.stack`` of per-layer trees would hold
every layer twice).  ``params_from_numpy`` takes the reference's pytree as
numpy arrays.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

__all__ = ["tree_map", "layer", "unstack", "init_stacked",
           "params_from_numpy"]

Params = dict[str, Any]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts), and of ``rest``,
    trees of the same structure, leaf by leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def layer(stacked: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return tree_map(lambda t: t[i], stacked)


def unstack(stacked: Params, n_layers: int) -> list[Params]:
    """Every layer's parameters (views), made by one ``torch.unbind`` per
    leaf: under autograd the layers' gradients gather into the stacked
    leaf's in one pass, where ``layer(stacked, i)`` for each layer would
    add a zero-filled gradient of the whole stack per layer."""
    parts = tree_map(lambda t: t.unbind(0), stacked)
    return [tree_map(lambda p: p[i], parts) for i in range(n_layers)]


def init_stacked(n_layers: int, init_one: Callable[[], Params]) -> Params:
    """``n_layers`` draws of ``init_one()`` (in order, each from the caller's
    generator) stacked on a leading axis, written in place layer by layer."""
    first = init_one()
    stacked = tree_map(lambda t: torch.empty((n_layers,) + tuple(t.shape),
                                             dtype=t.dtype, device=t.device),
                       first)

    def put(dst: Params, src: Params, i: int) -> None:
        for key, val in src.items():
            if isinstance(val, dict):
                put(dst[key], val, i)
            else:
                dst[key][i].copy_(val)

    put(stacked, first, 0)
    del first
    for i in range(1, n_layers):
        put(stacked, init_one(), i)
    return stacked


def params_from_numpy(tree: Params, device: torch.device | str) -> Params:
    """The reference's parameter pytree (numpy leaves, e.g. from
    ``jax.tree.map(np.asarray, params)``) as the port's tensors on
    ``device``: the same nesting, dtypes kept (bfloat16 leaves arrive as
    ml_dtypes arrays and are converted exactly through fp32)."""
    def leaf(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)
    return tree_map(leaf, tree)
