"""Token-choice top-k Mixture-of-Experts transformer in PyTorch
(granite-3.0-moe, qwen2-moe with shared experts), counterpart of the
reference ``repro/models/moe.py``.

Routing keeps the reference's semantics exactly (``moe.py:66-127``
there): tokens are split into groups of ``min(moe_group_size, n)``; the
router runs in fp32, its softmax's top k are taken with ties to the lower
expert index (``jax.lax.top_k``'s rule) and renormalised; within a group a
token's slot at an expert is its position in token order among the
group's tokens that chose that expert, and a token past the capacity
C = ceil(g·k/E·capacity_factor) is dropped there; padding tokens route
nowhere.  Where the reference contracts one-hot (G, T, E, C) tensors, the
port gathers: each expert's C slots per group are filled with their
tokens' rows (empty slots with a zero row), the experts run as batched
GEMMs over (E, G·C) rows — gate and up accumulated and kept in fp32
until silu(g)·u is rounded, the down product rounded to x's dtype, as the
reference's einsums — and each token sums its kept experts' outputs
weighted by its gates rounded to x's dtype, in fp32, rounded once.
Shared experts are added after.  ``moe_mlp`` also returns the router's
Switch-style load-balance loss, E·mean over groups of Σ_e (share of the
group's valid tokens choosing e)·(mean router probability of e), which
``loss_fn`` adds as ``router_aux_coef · Σ_layers aux / n_layers``;
serving ignores it.

The block, the stack, the cache and serving are ``transformer.py``'s with
this block's ``apply_one``/``decode_one``.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.tree import params_from_numpy, unstack

__all__ = ["init_moe_mlp", "capacity", "top_k", "route", "moe_mlp",
           "init_block", "block_apply", "block_apply_aux", "block_decode",
           "init", "params_from_numpy", "forward", "loss_fn", "init_cache",
           "cache_axes", "prefill", "decode_step"]

Params = dict[str, Any]


def init_moe_mlp(generator: torch.Generator, cfg: ModelConfig,
                 device: torch.device) -> Params:
    dtype = getattr(torch, cfg.param_dtype)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p: Params = {
        "router": L.normal(generator, (d, e), s_in, torch.float32, device),
        "w_gate": L.normal(generator, (e, d, f), s_in, dtype, device),
        "w_up": L.normal(generator, (e, d, f), s_in, dtype, device),
        "w_down": L.normal(generator, (e, f, d), s_out, dtype, device),
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = L.init_mlp(generator, d, cfg.n_shared_experts * f,
                                 dtype, device)
    return p


def capacity(cfg: ModelConfig, g_size: int) -> int:
    """Slots per expert in a group of ``g_size`` tokens (the reference's
    expression, evaluated in the same order)."""
    k, e = cfg.experts_per_token, cfg.n_experts
    return max(1, int(math.ceil(g_size * k / e * cfg.capacity_factor)))


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities of each row and their experts, in
    descending order, equal probabilities in index order (the rule of
    ``jax.lax.top_k``; a stable descending sort keeps it)."""
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    return gate[..., :k], expert[..., :k]


def _route(router: torch.Tensor, tokens: torch.Tensor, valid: torch.Tensor,
           cfg: ModelConfig):
    """``route``'s results after the router's softmax (G, T, E) fp32 and
    the 0/1 choices (G, T, E) of the valid tokens."""
    probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
    gate, expert = top_k(probs, cfg.experts_per_token)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    sel = torch.zeros(probs.shape, dtype=torch.int64, device=probs.device)
    sel.scatter_(-1, expert, valid.long()[..., None].expand_as(expert))
    pos = torch.cumsum(sel, dim=1) - 1                      # (G, T, E)
    slot = pos.gather(-1, expert)
    kept = valid[..., None] & (slot < capacity(cfg, tokens.shape[1]))
    return probs, sel, expert, gate, slot, kept


def route(router: torch.Tensor, tokens: torch.Tensor, valid: torch.Tensor,
          cfg: ModelConfig):
    """Routing of grouped tokens (G, T, d) with ``valid`` (G, T) bool.
    Returns (expert (G, T, k) int64, gate (G, T, k) fp32, slot (G, T, k)
    int64, kept (G, T, k) bool): the k experts of each token in descending
    probability (ties: lower index first), their renormalised gates, the
    token's queue position at each, and whether it fits the capacity."""
    return _route(router, tokens, valid, cfg)[2:]


def moe_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, the load-balance loss
    (0-d fp32))."""
    b, s, d = x.shape
    e = cfg.n_experts
    n = b * s
    g_size = min(cfg.moe_group_size, n)
    n_groups = -(-n // g_size)
    padded = n_groups * g_size
    cap = capacity(cfg, g_size)
    # the token rows, padded, then one zero row for empty slots
    rows = torch.zeros((padded + 1, d), dtype=x.dtype, device=x.device)
    rows[:n] = x.reshape(n, d)
    tokens = rows[:padded].view(n_groups, g_size, d)
    valid = (torch.arange(padded, device=x.device) < n).view(n_groups, g_size)
    probs, sel, expert, gate, slot, kept = _route(p["router"], tokens,
                                                  valid, cfg)
    # Switch-style load balance: the share of each group's tokens choosing
    # each expert (padding chooses none) against its mean probability
    aux = ((sel.float().mean(dim=1) * probs.mean(dim=1)).sum(dim=-1).mean()
           * e)

    # dispatch: slot (e, g, c) <- its token's row; kept (token, expert)
    # pairs fill distinct slots, the rest point at a spare slot
    g_idx = torch.arange(n_groups, device=x.device)[:, None, None]
    t_idx = torch.arange(g_size, device=x.device)[None, :, None]
    n_slots = e * n_groups * cap
    dest = torch.where(kept, (expert * n_groups + g_idx) * cap + slot, n_slots)
    src = (g_idx * g_size + t_idx).expand_as(dest)
    slot_row = torch.full((n_slots + 1,), padded, dtype=torch.int64,
                          device=x.device)
    slot_row.scatter_(0, dest.reshape(-1), src.reshape(-1))
    xin = rows[slot_row[:n_slots]].view(e, n_groups * cap, d)

    hg = L.bmm_fp32(xin, p["w_gate"])
    hu = L.bmm_fp32(xin, p["w_up"])
    hh = (torch.nn.functional.silu(hg) * hu).to(x.dtype)
    out_e = torch.bmm(hh, p["w_down"].to(x.dtype))          # (E, G·C, d)

    # combine: each token's kept experts, gates rounded to x's dtype
    out_rows = torch.cat([out_e.reshape(n_slots, d),
                          out_e.new_zeros((1, d))])
    picked = out_rows[dest.reshape(-1)].view(n_groups, g_size, -1, d)
    w = torch.where(kept, gate, 0.0).to(x.dtype).float()
    y = (w[..., None] * picked.float()).sum(dim=2).to(x.dtype)
    y = y.reshape(padded, d)[:n].reshape(b, s, d)
    if "shared" in p:
        y = y + L.mlp(p["shared"], x)
    return y, aux


# ------------------------- block + assembly -------------------------------

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
        "moe": init_moe_mlp(generator, cfg, device),
    }


def block_apply_aux(p: Params, h: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, *, mode: str | None = None):
    """One block on a whole sequence: (h, the block's load-balance loss)."""
    h, _ = T.attend(p, h, positions, cfg, mode)
    y, aux = moe_mlp(p["moe"], L.rms_norm(p["ln2"], h, cfg.norm_eps), cfg)
    return h + y, aux


def block_apply(p: Params, h: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, mode: str | None = None):
    h, kv = T.attend(p, h, positions, cfg, mode)
    y, _ = moe_mlp(p["moe"], L.rms_norm(p["ln2"], h, cfg.norm_eps), cfg)
    return h + y, kv


def block_decode(p: Params, h: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, cache_len: torch.Tensor,
                 positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = T.attend_decode(p, h, ck, cv, cache_len, positions, cfg)
    y, _ = moe_mlp(p["moe"], L.rms_norm(p["ln2"], h, cfg.norm_eps), cfg)
    return h + y


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device | str) -> Params:
    return T.init(generator, cfg, device, init_one=init_block)


def forward(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    return T.forward(params, batch, cfg, apply_one=block_apply)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig, *,
            mode: str | None = None) -> torch.Tensor:
    """Token cross-entropy plus ``router_aux_coef`` times the layers'
    mean load-balance loss, the aux carried through the layer loop as the
    reference carries it through its scan.  ``mode`` is the loss kernels'
    (K4/K5); attention trains on its plain version (K6 has no backward)."""
    h = T._embed_in(params, batch, cfg)
    positions = T._positions_of(batch, cfg, h)

    def body(h: torch.Tensor, lp: Params):
        return block_apply_aux(lp, h, positions, cfg, mode="ref")

    body = L.remat_wrap(cfg, body)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in unstack(params["layers"], cfg.n_layers):
        h, a = body(h, lp)
        aux = aux + a
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    logits = L.unembed(T._unembedding(params, cfg), h)
    loss = L.cross_entropy_loss(logits, batch["labels"], batch.get("mask"),
                                mode=mode)
    return loss + cfg.router_aux_coef * aux / cfg.n_layers


init_cache = T.init_cache
cache_axes = T.cache_axes


def prefill(params: Params, batch: dict, cfg: ModelConfig, max_len: int, *,
            mode: str | None = None) -> tuple[torch.Tensor, Params]:
    return T.prefill(params, batch, cfg, max_len, apply_one=block_apply,
                     mode=mode)


def decode_step(params: Params, cache: Params, batch: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, Params]:
    return T.decode_step(params, cache, batch, cfg, decode_one=block_decode)
