"""Encoder–decoder backbone (seamless-m4t-large-v2 style) in PyTorch,
counterpart of the reference ``repro/models/encdec.py``.

The audio/text modality front end is a stub, as in the reference: a batch
carries precomputed frame embeddings ``enc_embeds`` (B, S_enc, d_model)
and the decoder's tokens ``dec_tokens`` (B, S_dec).

``n_encoder_layers`` bidirectional encoder blocks, then ``n_layers``
decoder blocks, each with causal self-attention, cross-attention over the
encoder's memory and a SwiGLU MLP.  Parameters keep the reference's
pytree (``encoder`` and ``decoder`` stacked on a leading layer axis, drawn
layer by layer by ``tree.init_stacked``), so ``params_from_numpy`` maps
its parameters leaf for leaf.

On a prompt every attention goes through ``ops.flash_attention`` (K6):
the encoder's self-attention (full, Sq = Sk = S_enc), the decoder's
self-attention (causal) and its cross-attention (full, the decoder's S_dec
queries over the S_enc memory frames): 3 launches a decoder layer and 1 an
encoder layer.  The queries of cross-attention are rotated by the
decoder's positions and the memory's keys by the memory's positions, as
the reference rotates them (``prefill_attention_kv`` on the memory).
``prefill`` computes each layer's memory keys and values once and carries
them in the cache (``mem_k``, ``mem_v``) beside the self-attention cache;
``decode_step`` runs plain PyTorch, updates the cache in place and drops
a self-attention write past ``max_len``, as the reference does.

``loss_fn`` trains the model on the decoder's labels: every attention
(the encoder's, the decoder's causal self-attention and its
cross-attention over the memory) through K6 and its backward kernels
(``mode`` as in prefill), each encoder and decoder layer under
``layers.remat_wrap`` (the memory's cross-attention keys and values are
computed outside it, as the reference computes them before its decoder
scan), the token loss through K4/K5.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.tree import (
    init_stacked,
    layer,
    params_from_numpy,
    unstack,
)

__all__ = ["init_enc_block", "init_dec_block", "enc_block_apply",
           "dec_block_apply", "init", "params_from_numpy", "encode",
           "forward", "loss_fn", "init_cache", "cache_axes", "prefill",
           "decode_step"]

Params = dict[str, Any]


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _attn(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
          device: torch.device) -> Params:
    return L.init_attention(generator, cfg.d_model, cfg.n_heads,
                            cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
                            device)


def init_enc_block(generator: torch.Generator, cfg: ModelConfig,
                   device: torch.device) -> Params:
    dtype = getattr(torch, cfg.param_dtype)
    return {
        "ln1": L.init_rms_norm(cfg.d_model, dtype, device),
        "attn": _attn(generator, cfg, dtype, device),
        "ln2": L.init_rms_norm(cfg.d_model, dtype, device),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init_dec_block(generator: torch.Generator, cfg: ModelConfig,
                   device: torch.device) -> Params:
    dtype = getattr(torch, cfg.param_dtype)
    return {
        "ln1": L.init_rms_norm(cfg.d_model, dtype, device),
        "self_attn": _attn(generator, cfg, dtype, device),
        "ln_x": L.init_rms_norm(cfg.d_model, dtype, device),
        "cross_attn": _attn(generator, cfg, dtype, device),
        "ln2": L.init_rms_norm(cfg.d_model, dtype, device),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }


def enc_block_apply(p: Params, h: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, *, mode: str | None = None
                    ) -> torch.Tensor:
    a, _ = L.attention(p["attn"], L.rms_norm(p["ln1"], h, cfg.norm_eps),
                       positions, theta=cfg.rope_theta, eps=cfg.norm_eps,
                       causal=False, mode=mode)
    h = h + a
    return h + L.mlp(p["mlp"], L.rms_norm(p["ln2"], h, cfg.norm_eps))


def dec_block_apply(p: Params, h: torch.Tensor,
                    memory_kv: tuple[torch.Tensor, torch.Tensor],
                    positions: torch.Tensor, cfg: ModelConfig, *,
                    mode: str | None = None):
    """One decoder block on a whole sequence: (h, the self-attention's
    (k, v), what the cache holds)."""
    a, kv = L.attention(p["self_attn"], L.rms_norm(p["ln1"], h, cfg.norm_eps),
                        positions, theta=cfg.rope_theta, eps=cfg.norm_eps,
                        causal=True, mode=mode,
                        chunk_threshold=cfg.attn_chunk_threshold)
    h = h + a
    x, _ = L.attention(p["cross_attn"], L.rms_norm(p["ln_x"], h, cfg.norm_eps),
                       positions, theta=cfg.rope_theta, eps=cfg.norm_eps,
                       kv_override=memory_kv, mode=mode)
    h = h + x
    return h + L.mlp(p["mlp"], L.rms_norm(p["ln2"], h, cfg.norm_eps)), kv


# --------------------------------------------------------------------------
# assembly
# --------------------------------------------------------------------------

def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device | str) -> Params:
    """Random parameters in ``cfg.param_dtype``, drawn on ``device`` from
    ``generator`` (which must live there), each stack's layers straight
    into their stacked tensors."""
    device = torch.device(device)
    dtype = getattr(torch, cfg.param_dtype)
    return {
        "embedding": L.init_embedding(generator, cfg.padded_vocab,
                                      cfg.d_model, dtype, device),
        "encoder": init_stacked(cfg.n_encoder_layers,
                                lambda: init_enc_block(generator, cfg, device)),
        "decoder": init_stacked(cfg.n_layers,
                                lambda: init_dec_block(generator, cfg, device)),
        "enc_norm": L.init_rms_norm(cfg.d_model, dtype, device),
        "final_norm": L.init_rms_norm(cfg.d_model, dtype, device),
        "unembed": L.init_embedding(generator, cfg.padded_vocab, cfg.d_model,
                                    dtype, device),
    }


def _positions(bsz: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(bsz, s)


def encode(params: Params, enc_embeds: torch.Tensor, cfg: ModelConfig, *,
           mode: str | None = None) -> torch.Tensor:
    """The encoder's memory (B, S_enc, d) of the frame embeddings."""
    h = enc_embeds.to(getattr(torch, cfg.dtype))
    positions = _positions(h.shape[0], h.shape[1], h.device)
    for i in range(cfg.n_encoder_layers):
        h = enc_block_apply(layer(params["encoder"], i), h, positions, cfg,
                            mode=mode)
    return L.rms_norm(params["enc_norm"], h, cfg.norm_eps)


def _memory_kv(lp: Params, memory: torch.Tensor, cfg: ModelConfig):
    """One decoder layer's cross-attention keys and values (B, S_enc, KV,
    D) of the memory, the keys rotated by the memory's positions."""
    pos = _positions(memory.shape[0], memory.shape[1], memory.device)
    return L.prefill_attention_kv(lp["cross_attn"], memory, pos,
                                  theta=cfg.rope_theta, eps=cfg.norm_eps)


def _logits(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return L.unembed(params["unembed"],
                     L.rms_norm(params["final_norm"], h, cfg.norm_eps))


def forward(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, S_dec, V) fp32 of the decoder's whole sequence."""
    memory = encode(params, batch["enc_embeds"], cfg)
    h = L.embed(params["embedding"], batch["dec_tokens"],
                onehot=cfg.embed_onehot)
    positions = _positions(h.shape[0], h.shape[1], h.device)
    for i in range(cfg.n_layers):
        lp = layer(params["decoder"], i)
        h, _ = dec_block_apply(lp, h, _memory_kv(lp, memory, cfg), positions,
                               cfg)
    return _logits(params, h, cfg)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig, *,
            mode: str | None = None) -> torch.Tensor:
    """Mean token cross-entropy (0-d fp32) of ``batch["labels"]`` (B,
    S_dec), masked by ``batch["mask"]`` where given.  ``mode`` is the
    kernels' of the loss (K4/K5) and of every attention (K6 and its
    backward)."""
    h = batch["enc_embeds"].to(getattr(torch, cfg.dtype))
    enc_pos = _positions(h.shape[0], h.shape[1], h.device)

    def enc(h: torch.Tensor, lp: Params) -> torch.Tensor:
        return enc_block_apply(lp, h, enc_pos, cfg, mode=mode)

    enc = L.remat_wrap(cfg, enc)
    for lp in unstack(params["encoder"], cfg.n_encoder_layers):
        h = enc(h, lp)
    memory = L.rms_norm(params["enc_norm"], h, cfg.norm_eps)
    decoder = unstack(params["decoder"], cfg.n_layers)
    mem_kv = [_memory_kv(lp, memory, cfg) for lp in decoder]

    h = L.embed(params["embedding"], batch["dec_tokens"],
                onehot=cfg.embed_onehot)
    positions = _positions(h.shape[0], h.shape[1], h.device)

    def dec(h: torch.Tensor, lp: Params, mk: torch.Tensor,
            mv: torch.Tensor) -> torch.Tensor:
        return dec_block_apply(lp, h, (mk, mv), positions, cfg, mode=mode)[0]

    dec = L.remat_wrap(cfg, dec)
    for lp, kv in zip(decoder, mem_kv):
        h = dec(h, lp, *kv)
    return L.cross_entropy_loss(_logits(params, h, cfg), batch["labels"],
                                batch.get("mask"), mode=mode)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str,
               enc_len: int | None = None) -> Params:
    """The self-attention cache for ``max_len`` decoder positions and the
    memory's keys and values for ``enc_len`` frames (default
    ``max_len``, as the reference's ``get_model``)."""
    dtype = getattr(torch, cfg.dtype)
    kv, d = cfg.n_kv_heads, cfg.resolved_head_dim
    enc_len = max_len if enc_len is None else enc_len
    self_shape = (cfg.n_layers, batch, max_len, kv, d)
    mem_shape = (cfg.n_layers, batch, enc_len, kv, d)
    return {
        "k": torch.zeros(self_shape, dtype=dtype, device=device),
        "v": torch.zeros(self_shape, dtype=dtype, device=device),
        "mem_k": torch.zeros(mem_shape, dtype=dtype, device=device),
        "mem_v": torch.zeros(mem_shape, dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def cache_axes(cfg: ModelConfig) -> Params:
    ax = ("layers", "cache_batch", "cache_length", "cache_kv_heads",
          "cache_head_dim")
    return {"k": ax, "v": ax, "mem_k": ax, "mem_v": ax,
            "len": ("cache_batch",)}


def prefill(params: Params, batch: dict, cfg: ModelConfig, max_len: int, *,
            mode: str | None = None) -> tuple[torch.Tensor, Params]:
    """Encode ``enc_embeds``, run the decoder over ``dec_tokens``; return
    (last-position logits (B, 1, V) fp32, a fresh cache: the decoder's keys
    and values in a ``max_len``-deep cache, and each layer's memory keys
    and values, computed once here)."""
    memory = encode(params, batch["enc_embeds"], cfg, mode=mode)
    dec = batch["dec_tokens"]
    bsz, s = dec.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
    h = L.embed(params["embedding"], dec)
    positions = _positions(bsz, s, h.device)
    cache = init_cache(cfg, bsz, max_len, h.device, enc_len=memory.shape[1])
    for i in range(cfg.n_layers):
        lp = layer(params["decoder"], i)
        mk, mv = _memory_kv(lp, memory, cfg)
        cache["mem_k"][i] = mk
        cache["mem_v"][i] = mv
        h, (k, v) = dec_block_apply(lp, h, (mk, mv), positions, cfg,
                                    mode=mode)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    cache["len"].fill_(s)
    return _logits(params, h[:, -1:, :], cfg), cache


def decode_step(params: Params, cache: Params, batch: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, Params]:
    """One token per row.  batch["tokens"]: (B, 1).  Updates ``cache`` in
    place and returns (logits (B, 1, V) fp32, cache)."""
    h = L.embed(params["embedding"], batch["tokens"])
    cache_len = cache["len"]
    pos = cache_len[:, None]
    for i in range(cfg.n_layers):
        lp = layer(params["decoder"], i)
        a, _, _ = L.decode_attention(
            lp["self_attn"], L.rms_norm(lp["ln1"], h, cfg.norm_eps),
            cache["k"][i], cache["v"][i], cache_len, pos,
            theta=cfg.rope_theta, eps=cfg.norm_eps)
        h = h + a
        h = h + L.decode_cross_attention(
            lp["cross_attn"], L.rms_norm(lp["ln_x"], h, cfg.norm_eps),
            cache["mem_k"][i], cache["mem_v"][i], pos, theta=cfg.rope_theta,
            eps=cfg.norm_eps)
        h = h + L.mlp(lp["mlp"], L.rms_norm(lp["ln2"], h, cfg.norm_eps))
    logits = _logits(params, h, cfg)
    cache["len"] += 1
    return logits, cache
