"""Zamba2-style hybrid in PyTorch (arXiv:2411.15242), counterpart of the
reference ``repro/models/zamba2.py``: a Mamba2 backbone with ONE shared
attention block applied after every ``shared_attn_every`` Mamba layers.

The shared block's weights are reused at every invocation; each
invocation keeps its own KV cache.  It consumes concat(h, h0) — the
current hidden state and the original embeddings — projected back to
d_model.  Parameters keep the reference's pytree: the Mamba layers'
leaves are stacked on a leading layer axis (what ``jax.vmap`` of the
block init makes), so ``params_from_numpy`` maps the reference's
parameters leaf for leaf.

On a prompt, every Mamba layer runs its SSD intra-chunk term through
``ops.ssd_chunk`` (K7) and every shared-block invocation its causal
attention through ``ops.flash_attention`` (K6); ``mode`` threads down to
both (``"ref"`` selects the plain versions, for comparisons).  The cache
has the reference's leaves and layouts (``cache_axes``); ``decode_step``
updates it in place and returns it.

``loss_fn`` trains the model: the SSD and the shared attention on their
plain versions (``mode="ref"``; the reference trains through its jnp
paths, and K6/K7 have no backward), each Mamba layer under
``layers.remat_wrap`` as the reference checkpoints its Mamba scan body
(the shared block is not), the token loss through K4/K5.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.tree import init_stacked, params_from_numpy, unstack
from repro_torch.models.tree import layer as _layer
from repro_torch.models.tree import tree_map as _tree_map

__all__ = ["init", "params_from_numpy", "forward", "loss_fn", "init_cache",
           "cache_axes", "prefill", "decode_step", "n_shared_invocations"]

Params = dict[str, Any]


def _segments(cfg: ModelConfig) -> list[int]:
    """Mamba-layer counts per segment; a shared-attn invocation follows each
    full segment."""
    every = cfg.shared_attn_every or cfg.n_layers
    full, leftover = divmod(cfg.n_layers, every)
    return [every] * full + ([leftover] if leftover else [])


def n_shared_invocations(cfg: ModelConfig) -> int:
    every = cfg.shared_attn_every or cfg.n_layers
    return cfg.n_layers // every


# --------------------------------------------------------------------------
# shared attention block
# --------------------------------------------------------------------------

def init_shared_block(generator: torch.Generator, cfg: ModelConfig,
                      device: torch.device) -> Params:
    dtype = getattr(torch, cfg.param_dtype)
    d = cfg.d_model
    return {
        "in_proj": {"w": L.normal(generator, (2 * d, d),
                                  1.0 / math.sqrt(2 * d), dtype, device)},
        "ln1": L.init_rms_norm(d, dtype, device),
        "attn": L.init_attention(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.resolved_head_dim, dtype, device),
        "ln2": L.init_rms_norm(d, dtype, device),
        "mlp": L.init_mlp(generator, d, cfg.d_ff, dtype, device),
    }


def _shared_in(p: Params, h: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    x = torch.cat([h, h0], dim=-1)
    return torch.matmul(x, p["in_proj"]["w"].to(x.dtype)).to(h.dtype)


def _shared_out(p: Params, h: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    x = x + a
    x = x + L.mlp(p["mlp"], L.rms_norm(p["ln2"], x, cfg.norm_eps))
    return h + x


def shared_block_apply(p: Params, h: torch.Tensor, h0: torch.Tensor,
                       positions: torch.Tensor, cfg: ModelConfig, *,
                       mode: str | None = None):
    """The shared block on a whole sequence: (h, (k, v)), the keys and
    values its KV cache holds."""
    x = _shared_in(p, h, h0)
    a, kv = L.attention(p["attn"], L.rms_norm(p["ln1"], x, cfg.norm_eps),
                        positions, theta=cfg.rope_theta, causal=True,
                        window=cfg.attn_window, mode=mode)
    return _shared_out(p, h, x, a, cfg), kv


def shared_block_decode(p: Params, h: torch.Tensor, h0: torch.Tensor,
                        ck: torch.Tensor, cv: torch.Tensor,
                        cache_len: torch.Tensor, positions: torch.Tensor,
                        cfg: ModelConfig):
    x = _shared_in(p, h, h0)
    # The KV buffer is sized to attn_window (ring buffer): once cache_len
    # exceeds it, wrap the write slot; the full buffer is then the window,
    # so no extra window masking is needed.
    buf = ck.shape[1]
    a, ck, cv = L.decode_attention(
        p["attn"], L.rms_norm(p["ln1"], x, cfg.norm_eps), ck, cv, cache_len,
        positions, theta=cfg.rope_theta, write_pos=cache_len % buf)
    return _shared_out(p, h, x, a, cfg), ck, cv


# --------------------------------------------------------------------------
# assembly
# --------------------------------------------------------------------------

def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device | str) -> Params:
    """Random parameters in ``cfg.param_dtype`` (``a_log``, ``d_skip`` and
    ``dt_bias`` fp32), drawn on ``device`` from ``generator`` (which must
    live there)."""
    device = torch.device(device)
    dtype = getattr(torch, cfg.param_dtype)
    emb = L.init_embedding(generator, cfg.padded_vocab, cfg.d_model, dtype,
                           device)
    p: Params = {
        "embedding": emb,
        "mamba": init_stacked(cfg.n_layers,
                              lambda: M.init_block(generator, cfg, device)),
        "shared": init_shared_block(generator, cfg, device),
        "final_norm": L.init_rms_norm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.init_embedding(generator, cfg.padded_vocab,
                                        cfg.d_model, dtype, device)
    return p


def _positions(bsz: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(bsz, s)


def _is_full(seg: int, cfg: ModelConfig) -> bool:
    return seg == (cfg.shared_attn_every or cfg.n_layers)


def forward(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, S, V) fp32 of the whole sequence."""
    h = L.embed(params["embedding"], batch["tokens"])
    h0 = h
    bsz, s = batch["tokens"].shape
    positions = _positions(bsz, s, h.device)
    off = 0
    for seg in _segments(cfg):
        for i in range(off, off + seg):
            h = M.block_apply(_layer(params["mamba"], i), h, cfg)
        off += seg
        if _is_full(seg, cfg):
            h, _ = shared_block_apply(params["shared"], h, h0, positions,
                                      cfg)
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    emb = params["embedding"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(emb, h)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig, *,
            mode: str | None = None) -> torch.Tensor:
    """Mean token cross-entropy (0-d fp32), masked by ``batch["mask"]``
    where given.  ``mode`` is the loss kernels' (K4/K5)."""
    h = L.embed(params["embedding"], batch["tokens"])
    h0 = h
    bsz, s = batch["tokens"].shape
    positions = _positions(bsz, s, h.device)

    def mamba(h: torch.Tensor, lp: Params) -> torch.Tensor:
        return M.block_apply(lp, h, cfg, mode="ref")

    mamba = L.remat_wrap(cfg, mamba)
    layers = unstack(params["mamba"], cfg.n_layers)
    off = 0
    for seg in _segments(cfg):
        for i in range(off, off + seg):
            h = mamba(h, layers[i])
        off += seg
        if _is_full(seg, cfg):
            h, _ = shared_block_apply(params["shared"], h, h0, positions, cfg,
                                      mode="ref")
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    emb = params["embedding"] if cfg.tie_embeddings else params["unembed"]
    return L.cross_entropy_loss(L.unembed(emb, h), batch["labels"],
                                batch.get("mask"), mode=mode)


def _cache_len(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.attn_window) if cfg.attn_window else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> Params:
    d_in, g, n, h, conv_dim = M._dims(cfg)
    dtype = getattr(torch, cfg.dtype)
    inv = n_shared_invocations(cfg)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cache_len = _cache_len(cfg, max_len)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, h, d_in // h, n),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_kernel - 1,
                             conv_dim), dtype=dtype, device=device),
        "k": torch.zeros((inv, batch, cache_len, kv, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((inv, batch, cache_len, kv, hd), dtype=dtype,
                         device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def cache_axes(cfg: ModelConfig) -> Params:
    return {
        "ssm": ("layers", "cache_batch", "activation_heads", None, None),
        "conv": ("layers", "cache_batch", None, "activation_mlp"),
        "k": ("layers", "cache_batch", "cache_length", "cache_kv_heads",
              "cache_head_dim"),
        "v": ("layers", "cache_batch", "cache_length", "cache_kv_heads",
              "cache_head_dim"),
        "len": ("cache_batch",),
    }


def prefill(params: Params, batch: dict, cfg: ModelConfig, max_len: int, *,
            mode: str | None = None) -> tuple[torch.Tensor, Params]:
    """Run the prompt; return (last-position logits (B, 1, V) fp32, a
    fresh cache sized for ``max_len``)."""
    h = L.embed(params["embedding"], batch["tokens"])
    h0 = h
    bsz, s = batch["tokens"].shape
    positions = _positions(bsz, s, h.device)
    cache_len = _cache_len(cfg, max_len)

    ssm_states, conv_tails, ks, vs = [], [], [], []
    off = 0
    for seg in _segments(cfg):
        for i in range(off, off + seg):
            h, (st, tail) = M.block_apply(_layer(params["mamba"], i), h, cfg,
                                          return_states=True, mode=mode)
            ssm_states.append(st)
            conv_tails.append(tail)
        off += seg
        if _is_full(seg, cfg):
            h, (k, v) = shared_block_apply(params["shared"], h, h0,
                                           positions, cfg, mode=mode)
            pad = cache_len - k.shape[1]
            if pad >= 0:
                k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
                v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            else:  # windowed: keep the most recent ``cache_len`` entries
                k, v = k[:, -cache_len:], v[:, -cache_len:]
            ks.append(k)
            vs.append(v)

    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    emb = params["embedding"] if cfg.tie_embeddings else params["unembed"]
    logits = L.unembed(emb, h[:, -1:, :])
    kv_hd = (cfg.n_kv_heads, cfg.resolved_head_dim)
    empty = torch.zeros((0, bsz, cache_len) + kv_hd, dtype=h.dtype,
                        device=h.device)
    cache = {
        "ssm": torch.stack(ssm_states).float(),
        "conv": torch.stack(conv_tails),
        "k": torch.stack(ks) if ks else empty,
        "v": torch.stack(vs) if vs else empty,
        "len": torch.full((bsz,), min(s, cache_len), dtype=torch.int32,
                          device=h.device),
    }
    return logits, cache


def decode_step(params: Params, cache: Params, batch: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, Params]:
    """One token per row.  batch["tokens"]: (B, 1).  Updates ``cache`` in
    place (no copy of the KV or SSM state per step) and returns
    (logits (B, 1, V) fp32, cache)."""
    h = L.embed(params["embedding"], batch["tokens"])
    h0 = h
    cache_len = cache["len"]
    pos = cache_len[:, None]
    off, inv = 0, 0
    for seg in _segments(cfg):
        for i in range(off, off + seg):
            h, st, tail = M.block_decode(_layer(params["mamba"], i), h,
                                         cache["ssm"][i], cache["conv"][i],
                                         cfg)
            cache["ssm"][i].copy_(st)
            cache["conv"][i].copy_(tail)
        off += seg
        if _is_full(seg, cfg):
            h, _, _ = shared_block_decode(
                params["shared"], h, h0, cache["k"][inv], cache["v"][inv],
                cache_len, pos, cfg)
            inv += 1
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    emb = params["embedding"] if cfg.tie_embeddings else params["unembed"]
    logits = L.unembed(emb, h)
    cache["len"] += 1
    return logits, cache
