"""The LM train step, counterpart of the train half of the reference
``repro/launch/steps.py`` without its mesh and shardings.

``build_train_step(model, settings)`` returns ``step(state, batch) ->
(state, {"loss", "grad_norm"})`` in the reference's order: the loss and
its gradients (over ``settings.microbatches`` microbatches through
``gradsync.accumulate_grads`` where there are several), clipping by the
global norm, int8 error-feedback compression where asked, the AdamW
update, then ``step + 1``.  The state is a dict of tensors: ``params``,
``opt`` (AdamW's fp32 moments), ``step`` (0-d int32) and, with int8
compression, ``residual`` (fp32); the optimizer and the residual update
it in place, and the step returns it.  Nothing is read back to the host:
the metrics are 0-d tensors on the parameters' device.

The loss is the model's ``loss_fn``, whose token cross-entropy goes
through the softmax cross-entropy kernels (K4/K5) unless ``mode="ref"``;
attention and the SSD train on their plain versions (the reference trains
through its jnp paths, and K6/K7 have no backward).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.api import Model
from repro_torch.optim import adamw, clip_by_global_norm
from repro_torch.parallel import gradsync

__all__ = ["TrainSettings", "init_train_state", "build_train_step"]

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    grad_compression: str = "none"        # "none" | "int8"
    microbatches: int = 1


def _optimizer(settings: TrainSettings):
    return adamw(settings.learning_rate, weight_decay=settings.weight_decay)


def init_train_state(model: Model, settings: TrainSettings,
                     generator: torch.Generator,
                     device: torch.device | str) -> Params:
    """Random parameters drawn on ``device`` from ``generator`` (which must
    live there), zero fp32 moments, step 0, and the zero fp32 residual of
    int8 compression where ``settings`` asks for it."""
    params = model.init(generator, device)
    state = {
        "params": params,
        "opt": _optimizer(settings).init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if settings.grad_compression == "int8":
        state["residual"] = gradsync.init_residual(params)
    return state


def build_train_step(model: Model, settings: TrainSettings = TrainSettings(),
                     *, mode: str | None = None) -> Callable:
    """The train step of ``model`` under ``settings``; ``mode`` is the loss
    kernels' (``None``: K4/K5 on the card; ``"ref"``: their plain
    versions, for comparisons)."""
    if settings.grad_compression not in ("none", "int8"):
        raise ValueError(f"unknown grad_compression "
                         f"{settings.grad_compression!r}")
    opt = _optimizer(settings)

    def loss_fn(params: Params, batch: dict) -> torch.Tensor:
        return model.loss_fn(params, batch, mode=mode)

    def step(state: Params, batch: dict) -> tuple[Params, dict]:
        n = settings.microbatches
        if n > 1:
            micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss, grads = gradsync.accumulate_grads(loss_fn, state["params"],
                                                    micro)
        else:
            loss, grads = gradsync.value_and_grad(loss_fn)(state["params"],
                                                           batch)
        grads, gnorm = clip_by_global_norm(grads, settings.grad_clip)
        new_state = dict(state)
        if settings.grad_compression == "int8":
            grads, new_state["residual"] = gradsync.compress_grads_ef(
                grads, state["residual"])
        params, opt_state = opt.update(grads, state["opt"], state["params"],
                                       state["step"])
        new_state.update(params=params, opt=opt_state,
                         step=state["step"] + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step
