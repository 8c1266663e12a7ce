"""Uniform model interface, counterpart of the reference
``repro/models/api.py``: ``get_model(cfg)`` returns a ``Model`` whose
functions close over the config only — parameters, caches and batches
are explicit dicts of tensors.

All six families of the reference are ported: ``"dense"``
(``transformer.py``), ``"moe"`` (``moe.py``), ``"ssm"`` (the Mamba2 LM,
``mamba2.py``), ``"hybrid"`` (Zamba2, ``zamba2.py``), ``"encdec"``
(``encdec.py``) and ``"vlm"`` (``vlm.py``).  ``init_cache`` of an
encoder-decoder takes ``enc_len``, the memory's length (default
``max_len``), as the reference's does.
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
    init_cache: Callable[..., Params]        # (batch, max_len, device, **kw)
    cache_axes: Callable[[], Params]
    prefill: Callable[..., tuple]            # (params, batch, max_len, *, mode=None)
    decode_step: Callable[..., tuple]        # (params, cache, batch)


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def get_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam == "dense":
        from repro_torch.models import transformer as mod
    elif fam == "moe":
        from repro_torch.models import moe as mod
    elif fam == "ssm":
        from repro_torch.models import mamba2 as mod
    elif fam == "hybrid":
        from repro_torch.models import zamba2 as mod
    elif fam == "encdec":
        from repro_torch.models import encdec as mod
    elif fam == "vlm":
        from repro_torch.models import vlm as mod
    else:
        raise ValueError(f"unknown family {fam!r}")

    def init_cache(batch: int, max_len: int, device, **kw) -> Params:
        if fam == "encdec":
            return mod.init_cache(cfg, batch, max_len, device,
                                  kw.get("enc_len", max_len))
        return mod.init_cache(cfg, batch, max_len, device)

    return Model(
        cfg=cfg,
        init=lambda generator, device: mod.init(generator, cfg, device),
        params_from_numpy=mod.params_from_numpy,
        forward=lambda p, b: mod.forward(p, b, cfg),
        init_cache=init_cache,
        cache_axes=lambda: mod.cache_axes(cfg),
        prefill=lambda p, b, max_len, *, mode=None: mod.prefill(
            p, b, cfg, max_len, mode=mode),
        decode_step=lambda p, c, b: mod.decode_step(p, c, b, cfg),
    )
