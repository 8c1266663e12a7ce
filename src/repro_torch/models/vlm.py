"""Qwen2-VL-style VLM backbone in PyTorch, counterpart of the reference
``repro/models/vlm.py``: the dense transformer with M-RoPE.

The vision front end (ViT patch encoder, dynamic resolution) is a stub, as
in the reference: a prefill batch carries precomputed patch/text
embeddings ``embeds`` (B, S, d_model) and a 3-stream position tensor
``positions`` (3, B, S) (temporal / height / width) for M-RoPE; decode
takes tokens.  Everything else is ``transformer.py``'s, where
``cfg.mrope_sections`` turns on the sectioned rotary
(``layers.apply_mrope``).
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T

__all__ = ["init", "params_from_numpy", "forward", "init_cache",
           "cache_axes", "prefill", "decode_step", "make_text_positions",
           "make_image_positions"]

init = T.init
params_from_numpy = T.params_from_numpy
forward = T.forward
init_cache = T.init_cache
cache_axes = T.cache_axes
prefill = T.prefill
decode_step = T.decode_step


def make_text_positions(batch_size: int, seq_len: int,
                        device: torch.device | str | None = None
                        ) -> torch.Tensor:
    """Text-only M-RoPE positions (3, B, S): all three streams equal (the
    Qwen2-VL convention for pure-text segments)."""
    pos = torch.arange(seq_len, dtype=torch.int32, device=device)
    return pos.expand(3, batch_size, seq_len)


def make_image_positions(batch_size: int, t: int, h: int, w: int,
                         device: torch.device | str | None = None
                         ) -> torch.Tensor:
    """Grid M-RoPE positions (3, B, t·h·w) for a (t, h, w) patch grid
    flattened to a sequence: each stream indexes its own grid axis."""
    tt = torch.arange(t, device=device).repeat_interleave(h * w)
    hh = torch.arange(h, device=device).repeat_interleave(w).repeat(t)
    ww = torch.arange(w, device=device).repeat(t * h)
    pos = torch.stack([tt, hh, ww]).to(torch.int32)            # (3, t·h·w)
    return pos[:, None, :].expand(3, batch_size, t * h * w)
