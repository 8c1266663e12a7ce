"""Uniform model interface, counterpart of the reference
``repro/models/api.py``: ``get_model(cfg)`` returns a ``Model`` whose
functions close over the config only — parameters, caches and batches
are explicit dicts of tensors.

Families ``"dense"`` (``transformer.py``), ``"moe"`` (``moe.py``) and
``"hybrid"`` (Zamba2, ``zamba2.py``) are ported; ``"ssm"``, ``"encdec"``
and ``"vlm"`` raise ``NotImplementedError`` until their slices land
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig

__all__ = ["Model", "get_model", "PORTED_FAMILIES"]

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Params]              # (generator, device)
    params_from_numpy: Callable[..., Params]  # (numpy pytree, device)
    forward: Callable[..., Any]              # (params, batch)
    init_cache: Callable[..., Params]        # (batch, max_len, device)
    cache_axes: Callable[[], Params]
    prefill: Callable[..., tuple]            # (params, batch, max_len, *, mode=None)
    decode_step: Callable[..., tuple]        # (params, cache, batch)


PORTED_FAMILIES = ("dense", "moe", "hybrid")


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family == "dense":
        from repro_torch.models import transformer as mod
    elif cfg.family == "moe":
        from repro_torch.models import moe as mod
    elif cfg.family == "hybrid":
        from repro_torch.models import zamba2 as mod
    else:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (the port runs "
            f"{', '.join(PORTED_FAMILIES)}); see ROADMAP.md, queue 1")

    return Model(
        cfg=cfg,
        init=lambda generator, device: mod.init(generator, cfg, device),
        params_from_numpy=mod.params_from_numpy,
        forward=lambda p, b: mod.forward(p, b, cfg),
        init_cache=lambda batch, max_len, device: mod.init_cache(
            cfg, batch, max_len, device),
        cache_axes=lambda: mod.cache_axes(cfg),
        prefill=lambda p, b, max_len, *, mode=None: mod.prefill(
            p, b, cfg, max_len, mode=mode),
        decode_step=lambda p, c, b: mod.decode_step(p, c, b, cfg),
    )
