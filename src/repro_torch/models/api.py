"""Uniform model interface, counterpart of the reference
``repro/models/api.py``: ``get_model(cfg)`` returns a ``Model`` whose
functions close over the config only — parameters, caches and batches
are explicit dicts of tensors.

All six families of the reference are ported: ``"dense"``
(``transformer.py``), ``"moe"`` (``moe.py``), ``"ssm"`` (the Mamba2 LM,
``mamba2.py``), ``"hybrid"`` (Zamba2, ``zamba2.py``), ``"encdec"``
(``encdec.py``) and ``"vlm"`` (``vlm.py``).  ``init_cache`` of an
encoder-decoder takes ``enc_len``, the memory's length (default
``max_len``), as the reference's does.  ``loss_fn`` is the training loss
(``mode`` selects the loss kernels' path, as ``prefill``'s selects the
attention and SSD kernels').  ``input_specs(shape)`` is the batch of a
``ShapeSpec`` as meta tensors, with the reference's keys, shapes and
dtypes: what the dry-run feeds a step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec

__all__ = ["Model", "get_model", "PORTED_FAMILIES"]

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Params]              # (generator, device)
    params_from_numpy: Callable[..., Params]  # (numpy pytree, device)
    forward: Callable[..., Any]              # (params, batch)
    loss_fn: Callable[..., Any]              # (params, batch, *, mode=None)
    init_cache: Callable[..., Params]        # (batch, max_len, device, **kw)
    cache_axes: Callable[[], Params]
    prefill: Callable[..., tuple]            # (params, batch, max_len, *, mode=None)
    decode_step: Callable[..., tuple]        # (params, cache, batch)
    input_specs: Callable[[ShapeSpec], Params]


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Params:
    """The batch of ``shape`` for ``cfg``'s family as meta tensors: tokens
    (and labels to train); the VLM's front-end stub ``embeds`` (B, S, d)
    and M-RoPE ``positions`` (3, B, S); the encoder-decoder's ``enc_embeds``
    over S // 2 frames and ``dec_tokens`` over the rest.  Decode is one
    token a row, against a cache ``seq_len`` deep."""
    b, s, i32 = shape.global_batch, shape.seq_len, torch.int32
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), i32)}
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        out = {"embeds": _meta((b, s, cfg.d_model), dt),
               "positions": _meta((3, b, s), i32)}
    elif cfg.family == "encdec":
        enc_len = s // 2
        s = s - enc_len
        out = {"enc_embeds": _meta((b, enc_len, cfg.d_model), dt),
               "dec_tokens": _meta((b, s), i32)}
    else:
        out = {"tokens": _meta((b, s), i32)}
    if shape.kind == "train":
        out["labels"] = _meta((b, s), i32)
    return out


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
        loss_fn=lambda p, b, *, mode=None: mod.loss_fn(p, b, cfg, mode=mode),
        init_cache=init_cache,
        cache_axes=lambda: mod.cache_axes(cfg),
        prefill=lambda p, b, max_len, *, mode=None: mod.prefill(
            p, b, cfg, max_len, mode=mode),
        decode_step=lambda p, c, b: mod.decode_step(p, c, b, cfg),
        input_specs=lambda shape: input_specs(cfg, shape),
    )
