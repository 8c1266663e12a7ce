"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) in PyTorch,
counterpart of the reference ``repro/models/mamba2.py``: the chunked SSD,
its one-token recurrence, the Mamba2 block, and the attention-free Mamba2
LM (family ``"ssm"``, e.g. mamba2-2.7b) built on them.

Per head h with state size N and head dim P:

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_tᵀ        (state update)
    y_t = C_t h_t + D x_t                             (readout)

computed over a whole prompt with the chunked SSD algorithm: the
intra-chunk quadratic term, each chunk's final state and the in-chunk
decays come from ``ops.ssd_chunk`` (the SSD kernel, K7: all chunks and
heads in one launch); the inter-chunk recurrence on the (B, H, P, N)
fp32 states is a short loop over chunks, and the state-to-output readout
one batched product, both in fp32.  In bf16 this departs from the
reference's jnp SSD in four roundings: the intra-chunk weights, the
chunk-state decays and the readout's operands stay fp32 where the
reference rounds them to bf16, and y_diag is rounded to bf16 where the
reference keeps it fp32 (K7 returns x's dtype);
``tests/test_torch_zamba2_bf16.py`` and ``tests/test_torch_mamba2_lm.py``
name each with its measured size.

The LM's parameters keep the reference's pytree (the blocks' leaves
stacked on a leading layer axis, drawn layer by layer by
``tree.init_stacked``), tied embeddings unembed through ``embedding``,
and its cache is the recurrent state alone, of constant size: ``ssm``
(n_layers, B, H, P, N) fp32, ``conv`` (n_layers, B, K-1, conv_dim) and
``len``.  Every prefill runs one K7 launch per layer; ``decode_step``
updates the cache in place.  ``loss_fn`` trains the LM: the SSD through
K7 and its backward kernels (``ops.ssd_chunk``'s autograd function;
``mode="ref"`` selects the plain versions, for comparisons), each layer
under ``layers.remat_wrap``, the token loss through K4/K5.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.tree import (
    init_stacked,
    layer,
    params_from_numpy,
    unstack,
)

__all__ = ["ssd_chunked", "ssd_decode_step", "init_block", "block_apply",
           "block_decode", "init", "params_from_numpy", "forward", "loss_fn",
           "init_cache", "cache_axes", "prefill", "decode_step"]

Params = dict[str, Any]


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                initial_state: torch.Tensor | None = None, *,
                mode: str | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.

    x: (B, L, H, P) head inputs (dt folded in); dt_a: (B, L, H) log-decay
    per step (= dt·A, <= 0); b, c: (B, L, G, N), G groups broadcast over H.
    Returns (y (B, L, H, P) in x's dtype, final_state (B, H, P, N) fp32).
    """
    bs, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    nc = l // chunk
    rep = h // g

    # 1.-2. intra-chunk term, chunk states and in-chunk decays (K7; B and
    # C go in group-shaped, ops.ssd_chunk broadcasts them to the heads)
    y_diag, states, decay = ops.ssd_chunk(
        x.reshape(bs * nc, chunk, h, p),
        dt_a.reshape(bs * nc, chunk, h),
        b.reshape(bs * nc, chunk, g, n),
        c.reshape(bs * nc, chunk, g, n),
        mode=mode)
    states = states.reshape(bs, nc, h, p, n)
    decay = decay.reshape(bs, nc, chunk, h)
    chunk_decay = decay[:, :, -1, :]                            # (B, C, H)

    # 3. inter-chunk recurrence: the state entering each chunk
    carry = (torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    entry = []
    for ci in range(nc):
        entry.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    entry_states = torch.stack(entry, dim=1)                    # (B, C, H, P, N)

    # 4. state -> output within each chunk
    cg = c.reshape(bs, nc, chunk, g, n).float()
    eg = entry_states.reshape(bs, nc, g, rep * p, n)
    y_off = torch.einsum("bcqgn,bcgkn->bcqgk", cg, eg)
    y_off = y_off.reshape(bs, nc, chunk, h, p) * decay[..., None]
    y = (y_diag.reshape(bs, nc, chunk, h, p).float() + y_off)
    return y.reshape(bs, l, h, p).to(x.dtype), carry


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt_a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence.  state: (B, H, P, N); x: (B, H, P); dt_a:
    (B, H); b, c: (B, G, N).  Returns (y (B, H, P), new_state fp32)."""
    h = x.shape[1]
    bh = ops.heads_of_groups(b, h).float()                      # (B, H, N)
    ch = ops.heads_of_groups(c, h).float()
    decay = torch.exp(dt_a)[..., None, None]                    # (B, H, 1, 1)
    upd = bh[:, :, None, :] * x.float()[..., None]              # (B, H, P, N)
    new_state = state * decay + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    return y.to(x.dtype), new_state


# --------------------------------------------------------------------------
# Mamba2 block
# --------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h = cfg.ssm_heads
    conv_dim = d_in + 2 * g * n
    return d_in, g, n, h, conv_dim


def init_block(generator: torch.Generator, cfg: ModelConfig,
               device: torch.device) -> Params:
    dtype = getattr(torch, cfg.param_dtype)
    d_in, g, n, h, conv_dim = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * d_in + 2 * g * n + h
    # dt bias init: softplus^-1 of dt in [1e-3, 1e-1] (mamba convention)
    u = torch.empty((h,), device=device, dtype=torch.float32).uniform_(
        math.log(1e-3), math.log(1e-1), generator=generator)
    dt_init = torch.exp(u)
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    return {
        "norm": L.init_rms_norm(d, dtype, device),
        "in_proj": {"w": L.normal(generator, (d, proj_out), 1.0 / math.sqrt(d),
                                  dtype, device)},
        "conv_w": L.normal(generator, (cfg.conv_kernel, conv_dim),
                           1.0 / math.sqrt(cfg.conv_kernel), dtype, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=device)),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": dt_bias,
        "gated_norm": L.init_rms_norm(d_in, dtype, device),
        "out_proj": {"w": L.normal(generator, (d_in, d), 1.0 / math.sqrt(d_in),
                                   dtype, device)},
    }


def _split_proj(z_xbc_dt: torch.Tensor, cfg: ModelConfig):
    d_in, g, n, h, conv_dim = _dims(cfg)
    z = z_xbc_dt[..., :d_in]
    xbc = z_xbc_dt[..., d_in:d_in + conv_dim]
    dt = z_xbc_dt[..., d_in + conv_dim:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 prev_tail: torch.Tensor | None = None):
    """Depthwise causal conv along L.  xbc: (B, L, C); conv_w: (K, C).
    Returns (silu(conv) in xbc's dtype, the last K-1 inputs)."""
    k = conv_w.shape[0]
    if prev_tail is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = prev_tail.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                          # (B, L+K-1, C)
    length = xbc.shape[1]
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):                                         # K is tiny (4)
        out = out + xp[:, i:i + length, :].float() * conv_w[i].float()
    out = out + conv_b.float()
    return F.silu(out).to(xbc.dtype), xp[:, -(k - 1):, :]


def _gate_and_project(p: Params, y: torch.Tensor, z: torch.Tensor,
                      hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y = L.rms_norm(p["gated_norm"], y * F.silu(z.float()).to(y.dtype),
                   cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"]["w"].to(y.dtype)).to(hidden.dtype)
    return hidden + out


def block_apply(p: Params, hidden: torch.Tensor, cfg: ModelConfig,
                initial_state: torch.Tensor | None = None,
                conv_tail: torch.Tensor | None = None,
                return_states: bool = False, *, mode: str | None = None):
    """Full-sequence Mamba2 mixer with pre-norm and residual.  hidden:
    (B, L, d).  With ``return_states``, also (final SSM state, conv tail)."""
    d_in, g, n, h, conv_dim = _dims(cfg)
    bsz, l, _ = hidden.shape
    x_in = L.rms_norm(p["norm"], hidden, cfg.norm_eps)
    zxbcdt = torch.matmul(x_in, p["in_proj"]["w"].to(x_in.dtype)).to(hidden.dtype)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc, tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_tail)
    xs = xbc[..., :d_in].reshape(bsz, l, h, d_in // h)
    b = xbc[..., d_in:d_in + g * n].reshape(bsz, l, g, n)
    c = xbc[..., d_in + g * n:].reshape(bsz, l, g, n)
    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B, L, H)
    a = -torch.exp(p["a_log"])                                  # (H,)
    dt_a = dt * a                                               # (B, L, H) <= 0
    # fold dt into the input branch (SSD convention: x <- x * dt)
    x_dt = (xs.float() * dt[..., None]).to(xs.dtype)
    y, final_state = ssd_chunked(x_dt, dt_a, b, c, cfg.ssm_chunk,
                                 initial_state, mode=mode)
    y = y + xs * p["d_skip"][None, None, :, None].to(xs.dtype)
    res = _gate_and_project(p, y.reshape(bsz, l, d_in), z, hidden, cfg)
    if return_states:
        return res, (final_state, tail)
    return res


def block_decode(p: Params, hidden: torch.Tensor, ssm_state: torch.Tensor,
                 conv_tail: torch.Tensor, cfg: ModelConfig):
    """One-token step.  hidden: (B, 1, d).  Returns (hidden, new SSM state,
    new conv tail)."""
    d_in, g, n, h, conv_dim = _dims(cfg)
    bsz = hidden.shape[0]
    x_in = L.rms_norm(p["norm"], hidden, cfg.norm_eps)
    zxbcdt = torch.matmul(x_in, p["in_proj"]["w"].to(x_in.dtype)).to(hidden.dtype)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc, tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_tail)
    xs = xbc[:, 0, :d_in].reshape(bsz, h, d_in // h)
    b = xbc[:, 0, d_in:d_in + g * n].reshape(bsz, g, n)
    c = xbc[:, 0, d_in + g * n:].reshape(bsz, g, n)
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])           # (B, H)
    a = -torch.exp(p["a_log"])
    x_dt = (xs.float() * dt1[..., None]).to(xs.dtype)
    y, new_state = ssd_decode_step(ssm_state, x_dt, dt1 * a, b, c)
    y = y + xs * p["d_skip"][None, :, None].to(xs.dtype)
    out = _gate_and_project(p, y.reshape(bsz, 1, d_in), z, hidden, cfg)
    return out, new_state, tail


# --------------------------------------------------------------------------
# whole LM (attention-free)
# --------------------------------------------------------------------------

def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device | str) -> Params:
    """Random parameters in ``cfg.param_dtype``, drawn on ``device`` from
    ``generator`` (which must live there), the layers straight into their
    stacked tensors."""
    device = torch.device(device)
    dtype = getattr(torch, cfg.param_dtype)
    p: Params = {
        "embedding": L.init_embedding(generator, cfg.padded_vocab,
                                      cfg.d_model, dtype, device),
        "layers": init_stacked(cfg.n_layers,
                               lambda: init_block(generator, cfg, device)),
        "final_norm": L.init_rms_norm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.init_embedding(generator, cfg.padded_vocab,
                                        cfg.d_model, dtype, device)
    return p


def _logits(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    emb = params["embedding"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(emb, h)


def forward(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, S, V) fp32 of the whole sequence (S a multiple of
    ``ssm_chunk``)."""
    h = L.embed(params["embedding"], batch["tokens"],
                onehot=cfg.embed_onehot)
    for i in range(cfg.n_layers):
        h = block_apply(layer(params["layers"], i), h, cfg)
    return _logits(params, h, cfg)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig, *,
            mode: str | None = None) -> torch.Tensor:
    """Mean token cross-entropy (0-d fp32), masked by ``batch["mask"]``
    where given.  ``mode`` is the kernels' of the SSD (K7 and its
    backward) and of the loss (K4/K5)."""
    h = L.embed(params["embedding"], batch["tokens"],
                onehot=cfg.embed_onehot)

    def body(h: torch.Tensor, lp: Params) -> torch.Tensor:
        return block_apply(lp, h, cfg, mode=mode)

    body = L.remat_wrap(cfg, body)
    for lp in unstack(params["layers"], cfg.n_layers):
        h = body(h, lp)
    return L.cross_entropy_loss(_logits(params, h, cfg), batch["labels"],
                                batch.get("mask"), mode=mode)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> Params:
    """The recurrent state: its size does not depend on ``max_len``."""
    del max_len
    d_in, g, n, h, conv_dim = _dims(cfg)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, h, d_in // h, n),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_kernel - 1,
                             conv_dim), dtype=getattr(torch, cfg.dtype),
                            device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def cache_axes(cfg: ModelConfig) -> Params:
    return {
        "ssm": ("layers", "cache_batch", "activation_heads", None, None),
        "conv": ("layers", "cache_batch", None, "activation_mlp"),
        "len": ("cache_batch",),
    }


def prefill(params: Params, batch: dict, cfg: ModelConfig, max_len: int, *,
            mode: str | None = None) -> tuple[torch.Tensor, Params]:
    """Run the prompt (a multiple of ``ssm_chunk`` tokens); return
    (last-position logits (B, 1, V) fp32, a fresh cache holding every
    layer's final SSM state and conv tail)."""
    h = L.embed(params["embedding"], batch["tokens"],
                onehot=cfg.embed_onehot)
    bsz, s = batch["tokens"].shape
    cache = init_cache(cfg, bsz, max_len, h.device)
    for i in range(cfg.n_layers):
        h, (st, tail) = block_apply(layer(params["layers"], i), h, cfg,
                                    return_states=True, mode=mode)
        cache["ssm"][i].copy_(st)
        cache["conv"][i].copy_(tail)
    cache["len"].fill_(s)
    return _logits(params, h[:, -1:, :], cfg), cache


def decode_step(params: Params, cache: Params, batch: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, Params]:
    """One token per row.  batch["tokens"]: (B, 1).  Updates ``cache`` in
    place and returns (logits (B, 1, V) fp32, cache)."""
    h = L.embed(params["embedding"], batch["tokens"])
    for i in range(cfg.n_layers):
        h, st, tail = block_decode(layer(params["layers"], i), h,
                                   cache["ssm"][i], cache["conv"][i], cfg)
        cache["ssm"][i].copy_(st)
        cache["conv"][i].copy_(tail)
    logits = _logits(params, h, cfg)
    cache["len"] += 1
    return logits, cache
