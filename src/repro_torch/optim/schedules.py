"""Learning-rate schedules (step -> lr), counterpart of the reference
``repro/optim/schedules.py``.  A schedule takes the step as an fp32
tensor (0-d, on any device) and returns the rate as an fp32 tensor on
the same device, computed in fp32 as the reference computes it, so the
optimizer never reads a value back to the host."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def cosine_decay(lr: float, steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1.0 - final_frac) * cos)
    return fn


def linear_warmup_cosine(lr: float, warmup: int, steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(1, steps - warmup), final_frac)

    def fn(step):
        step = _f32(step)
        warm = lr * step / max(1, warmup)
        return torch.where(step < warmup, warm, cos(step - warmup))
    return fn
