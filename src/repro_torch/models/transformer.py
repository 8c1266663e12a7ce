"""Dense decoder-only transformer LM in PyTorch (qwen2.5 / qwen1.5 / qwen3
/ granite flavours: GQA, optional QKV bias, optional qk-norm; Qwen2-VL's
M-RoPE where ``cfg.mrope_sections`` is set), counterpart of the reference
``repro/models/transformer.py``.

A batch carries ``tokens`` (B, S), or the modality front end's stub
``embeds`` (B, S, d_model) in their place, and optionally ``positions``:
(B, S), or (3, B, S) for M-RoPE (``vlm.make_image_positions``); without
them the positions are 0..S-1, broadcast to the three streams for M-RoPE.
Decode takes tokens and rotates by the cache length (on every stream).

Parameters keep the reference's pytree: the blocks' leaves stacked on a
leading "layers" axis, so ``params_from_numpy`` maps the reference's
parameters leaf for leaf; ``init`` draws the layers one at a time into the
stacked tensors (``tree.init_stacked``), so initialising the full-width
model holds its weights once.  The stack runs as a Python loop over layer
views where the reference scans.

On a prompt every block's causal self-attention goes through
``ops.flash_attention`` (K6, grouped-query heads in the kernel); ``mode``
threads down to it (``"ref"`` selects the plain version, for
comparisons).  ``prefill`` projects each layer's keys and values once and
writes them into a cache sized for ``max_len`` — what the reference's
cache holds after its second projection (``prefill_attention_kv``) and
its pad.  The cache is (n_layers, B, max_len, KV, D) under the
reference's axis names (``cache_axes``); ``decode_step`` writes it in
place and returns it, dropping a write past ``max_len`` as the reference
does.

The stack machinery (``block_apply``/``block_decode`` taken as
``apply_one``/``decode_one``) is shared with ``moe.py``.

``loss_fn`` is the training loss: the token cross-entropy through the
softmax cross-entropy kernels (K4/K5), each layer under
``layers.remat_wrap`` where the reference checkpoints its scan body, and
attention through K6 and its backward kernels; ``mode`` selects the
kernels for both as it does in prefill (``"ref"``: the plain versions).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.tree import (
    init_stacked,
    layer,
    params_from_numpy,
    unstack,
)

__all__ = ["init_block", "block_apply", "block_decode", "init",
           "params_from_numpy", "forward", "loss_fn", "init_cache",
           "cache_axes", "prefill", "decode_step"]

Params = dict[str, Any]


# --------------------------------------------------------------------------
# single block
# --------------------------------------------------------------------------

def init_block(generator: torch.Generator, cfg: ModelConfig,
               device: torch.device) -> Params:
    dtype = getattr(torch, cfg.param_dtype)
    return {
        "ln1": L.init_rms_norm(cfg.d_model, dtype, device),
        "attn": L.init_attention(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, dtype, device, qkv_bias=cfg.qkv_bias,
            qk_norm=cfg.qk_norm),
        "ln2": L.init_rms_norm(cfg.d_model, dtype, device),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }


def attend(p: Params, h: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig, mode: str | None):
    """(h + attention(ln1(h)), the layer's (k, v))."""
    a, kv = L.attention(p["attn"], L.rms_norm(p["ln1"], h, cfg.norm_eps),
                        positions, theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                        eps=cfg.norm_eps, mrope_sections=cfg.mrope_sections,
                        causal=True, mode=mode,
                        chunk_threshold=cfg.attn_chunk_threshold)
    return h + a, kv


def attend_decode(p: Params, h: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor, cache_len: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """h + decode_attention(ln1(h)); writes the layer's cache in place."""
    a, _, _ = L.decode_attention(
        p["attn"], L.rms_norm(p["ln1"], h, cfg.norm_eps), ck, cv, cache_len,
        positions, theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        eps=cfg.norm_eps, mrope_sections=cfg.mrope_sections,
        window=cfg.attn_window)
    return h + a


def block_apply(p: Params, h: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, mode: str | None = None):
    """One block on a whole sequence: (h, the layer's (k, v))."""
    h, kv = attend(p, h, positions, cfg, mode)
    h = h + L.mlp(p["mlp"], L.rms_norm(p["ln2"], h, cfg.norm_eps))
    return h, kv


def block_decode(p: Params, h: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, cache_len: torch.Tensor,
                 positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = attend_decode(p, h, ck, cv, cache_len, positions, cfg)
    return h + L.mlp(p["mlp"], L.rms_norm(p["ln2"], h, cfg.norm_eps))


# --------------------------------------------------------------------------
# whole LM
# --------------------------------------------------------------------------

def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device | str, init_one: Callable = init_block
         ) -> Params:
    """Random parameters in ``cfg.param_dtype``, drawn on ``device`` from
    ``generator`` (which must live there), the layers straight into their
    stacked tensors."""
    device = torch.device(device)
    dtype = getattr(torch, cfg.param_dtype)
    p: Params = {
        "embedding": L.init_embedding(generator, cfg.padded_vocab,
                                      cfg.d_model, dtype, device),
        "layers": init_stacked(cfg.n_layers,
                               lambda: init_one(generator, cfg, device)),
        "final_norm": L.init_rms_norm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.init_embedding(generator, cfg.padded_vocab,
                                        cfg.d_model, dtype, device)
    return p


def _positions(bsz: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(bsz, s)


def _embed_in(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, d): ``embeds`` in the activation dtype (the vlm front end's
    stub), else the tokens' embeddings."""
    if "embeds" in batch:
        return batch["embeds"].to(getattr(torch, cfg.dtype))
    return L.embed(params["embedding"], batch["tokens"],
                   onehot=cfg.embed_onehot)


def _positions_of(batch: dict, cfg: ModelConfig,
                  h: torch.Tensor) -> torch.Tensor:
    """``batch["positions"]``, else 0..S-1: (B, S), or (3, B, S) for
    M-RoPE."""
    if "positions" in batch:
        return batch["positions"]
    pos = _positions(h.shape[0], h.shape[1], h.device)
    return pos.expand(3, *pos.shape) if cfg.mrope_sections else pos


def _unembedding(params: Params, cfg: ModelConfig) -> Params:
    return params["embedding"] if cfg.tie_embeddings else params["unembed"]


def _logits(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    return L.unembed(_unembedding(params, cfg), h)


def forward(params: Params, batch: dict, cfg: ModelConfig,
            apply_one: Callable = block_apply) -> torch.Tensor:
    """Logits (B, S, V) fp32 of the whole sequence."""
    h = _embed_in(params, batch, cfg)
    positions = _positions_of(batch, cfg, h)
    for i in range(cfg.n_layers):
        h, _ = apply_one(layer(params["layers"], i), h, positions, cfg)
    return _logits(params, h, cfg)


def train_stack(params: Params, batch: dict, cfg: ModelConfig,
                apply_one: Callable = block_apply, *,
                mode: str | None = None) -> torch.Tensor:
    """The final-normed hidden states (B, S, d) of the training forward:
    every layer under ``remat_wrap``, attention in ``mode``."""
    h = _embed_in(params, batch, cfg)
    positions = _positions_of(batch, cfg, h)

    def body(h: torch.Tensor, lp: Params) -> torch.Tensor:
        return apply_one(lp, h, positions, cfg, mode=mode)[0]

    body = L.remat_wrap(cfg, body)
    for lp in unstack(params["layers"], cfg.n_layers):
        h = body(h, lp)
    return L.rms_norm(params["final_norm"], h, cfg.norm_eps)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig,
            apply_one: Callable = block_apply, *,
            mode: str | None = None) -> torch.Tensor:
    """Mean token cross-entropy (0-d fp32) of ``batch["labels"]`` (B, S),
    masked by ``batch["mask"]`` where given; with ``cfg.fused_ce`` and no
    mask, the unembedding and the loss are fused over length chunks
    (``layers.fused_unembed_ce``).  ``mode`` is the kernels' of the loss
    (K4/K5) and of attention (K6 and its backward)."""
    h = train_stack(params, batch, cfg, apply_one, mode=mode)
    emb = _unembedding(params, cfg)
    if cfg.fused_ce and "mask" not in batch:
        return L.fused_unembed_ce(emb, h, batch["labels"], mode=mode)
    return L.cross_entropy_loss(L.unembed(emb, h), batch["labels"],
                                batch.get("mask"), mode=mode)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> Params:
    dtype = getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def cache_axes(cfg: ModelConfig) -> Params:
    ax = ("layers", "cache_batch", "cache_length", "cache_kv_heads",
          "cache_head_dim")
    return {"k": ax, "v": ax, "len": ("cache_batch",)}


def prefill(params: Params, batch: dict, cfg: ModelConfig, max_len: int,
            apply_one: Callable = block_apply, *,
            mode: str | None = None) -> tuple[torch.Tensor, Params]:
    """Run the prompt; return (last-position logits (B, 1, V) fp32, a fresh
    cache sized for ``max_len`` holding the prompt's keys and values)."""
    h = _embed_in(params, batch, cfg)
    bsz, s = h.shape[0], h.shape[1]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
    positions = _positions_of(batch, cfg, h)
    cache = init_cache(cfg, bsz, max_len, h.device)
    for i in range(cfg.n_layers):
        h, (k, v) = apply_one(layer(params["layers"], i), h, positions, cfg,
                              mode=mode)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    cache["len"].fill_(s)
    return _logits(params, h[:, -1:, :], cfg), cache


def decode_step(params: Params, cache: Params, batch: dict, cfg: ModelConfig,
                decode_one: Callable = block_decode
                ) -> tuple[torch.Tensor, Params]:
    """One token per row.  batch["tokens"]: (B, 1).  Updates ``cache`` in
    place (no copy of the KV cache per step) and returns (logits (B, 1, V)
    fp32, cache)."""
    h = _embed_in(params, batch, cfg)
    cache_len = cache["len"]
    pos = cache_len[:, None]
    if cfg.mrope_sections:
        pos = pos.expand(3, *pos.shape)
    for i in range(cfg.n_layers):
        h = decode_one(layer(params["layers"], i), h, cache["k"][i],
                       cache["v"][i], cache_len, pos, cfg)
    logits = _logits(params, h, cfg)
    cache["len"] += 1
    return logits, cache
