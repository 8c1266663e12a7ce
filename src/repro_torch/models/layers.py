"""Shared LM primitives in PyTorch, counterpart of the reference
``repro/models/layers.py``: what the six LM families run to serve and to
train (the loss, its fused unembedding and the activation-checkpoint
wrapper).

Conventions, as in the reference:
  * params are dicts of tensors with the reference's names and layouts,
    so ``params_from_numpy`` takes its pytree unchanged;
  * activations run in the config's dtype; products accumulate in fp32 and
    are rounded to the activation dtype (what ``preferred_element_type``
    then ``astype`` does in the reference), except SwiGLU's gate and up
    products, which stay fp32 until silu(g)·u is rounded, as the
    reference leaves them; norms, RoPE and softmax in fp32; logits in
    fp32.
  * initializers draw on an explicit ``torch.Generator`` and place the
    tensors on ``device``.

Attention follows the reference's contract: grouped-query attention
(``n_kv_heads`` dividing ``n_heads``), optional QKV bias (added after the
projection is rounded to x's dtype), optional qk-norm (RMS over
head_dim, then RoPE) and, where ``mrope_sections`` is given, Qwen2-VL's
multimodal RoPE over (3, B, L) positions.  The attention of a whole
sequence goes through ``ops.flash_attention`` (the flash kernel, K6,
which groups the query heads itself) at every length: causal
self-attention (the reference's masked ``_sdpa`` and its kv-chunked twin
``_sdpa_chunked_causal``), the encoder's full self-attention, and
cross-attention (``kv_override``: the queries rotated by their own
positions over keys and values computed elsewhere, as
``prefill_attention_kv`` computes them for the encoder's memory, never
causal), and causal self-attention with a sliding window (``window``:
key k kept for query q where q - window < k <= q, the reference's mask
for a prefill longer than ``attn_window``), which the kernel computes in
O(L·window) by skipping the key tiles below the window.  Decode attention (one query against the cache, or against
the encoder's memory) stays plain PyTorch, as the reference computes it
outside any kernel.

The token loss (``cross_entropy_loss``, ``fused_unembed_ce``) goes
through ``ops.softmax_xent``: the softmax cross-entropy kernels K4/K5 on
the card, their plain versions on the CPU.  ``remat_wrap`` is the
reference's scan-body checkpoint policy as ``torch.utils.checkpoint``.

The reference's dynamically scoped product dtype (``use_accum_dtype``,
``pet()``) is kept: the products it governs there (the unembedding,
SwiGLU's gate and up, the one-hot embedding) go through ``matmul_acc``,
fp32 under the default ``"float32"`` and the activation dtype under
``"bfloat16"``.  ``embed(..., onehot=True)`` is the reference's one-hot
matmul lookup, chunked over length.  Causal self-attention whose Lq·Lk
exceeds ``chunk_threshold`` takes, on the plain path (``mode="ref"``),
the reference's kv-chunked online softmax with its flash-style backward
(``_SdpaChunkedCausal``); the kernel path keeps K6 at every length, in
training too, where ``ops.flash_attention`` differentiates through K6's
backward kernels.

On the card a bf16 product with fp32 output (``matmul_fp32``,
``bmm_fp32``) is one GEMM writing fp32; PyTorch has no derivative for
that form, so it runs as an autograd function (``_GemmF32``).  JAX's
transpose multiplies the fp32 cotangent by the upcast operand; the
backward here splits the cotangent into two bf16 halves, hi + lo, and
runs each product as two bf16 GEMMs summed in fp32 and rounded once to
bf16 (``gemm_f32_grads``): ~16 of the cotangent's bits instead of the 8
of one rounding, at twice the GEMMs.  On the CPU the product runs on the
upcast operands and autograd gives exactly JAX's transpose.  Meta tensors
(the dry-run) take the card's branch.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.kernels import ops

__all__ = [
    "init_rms_norm", "rms_norm", "dense", "init_embedding",
    "embed", "unembed", "rope_freqs", "apply_rope", "apply_mrope",
    "init_attention", "attention", "prefill_attention_kv",
    "decode_attention", "decode_cross_attention", "init_mlp",
    "mlp", "matmul_fp32", "bmm_fp32", "matmul_acc", "use_accum_dtype",
    "pet", "normal", "cross_entropy_loss", "fused_unembed_ce", "remat_wrap",
    "gemm_f32_grads",
]

Params = dict[str, Any]

# The reference's dynamically scoped product output dtype
# (``preferred_element_type``): fp32 by default; the bf16comm variants set
# bf16.  Norms, RoPE and softmax stay fp32 regardless.
_PET = [torch.float32]


class use_accum_dtype:
    """``with use_accum_dtype("bfloat16"):`` products through
    ``matmul_acc`` return that dtype inside the block."""

    def __init__(self, dtype: str | torch.dtype):
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def __enter__(self) -> torch.dtype:
        _PET.append(self.dtype)
        return self.dtype

    def __exit__(self, *exc) -> bool:
        _PET.pop()
        return False


def pet() -> torch.dtype:
    return _PET[-1]


def normal(generator: torch.Generator, shape: tuple[int, ...], scale: float,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, scale²) drawn in fp32 on ``device`` from ``generator``, then
    cast to ``dtype`` (the reference's ``normal(key, shape) * s`` then
    ``astype``)."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def init_rms_norm(d: int, dtype: torch.dtype, device: torch.device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# dense
# --------------------------------------------------------------------------

def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = (y.float() + p["b"].float()).to(x.dtype)
    return y


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------

def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype, device: torch.device) -> Params:
    return {"w": normal(generator, (vocab, d), 0.02, dtype, device)}


def embed(p: Params, tokens: torch.Tensor, onehot: bool = False,
          chunk: int = 512) -> torch.Tensor:
    """tokens (B, L) integer -> (B, L, d) in the table's dtype: a row
    gather, or with ``onehot`` the reference's one-hot matmul, chunked over
    length so a (B, chunk, V) one-hot slab is live at a time (the whole
    length where ``chunk`` does not divide it); each product's single
    nonzero term makes it equal to the gather."""
    w = p["w"]
    if not onehot:
        return w[tokens.long()]
    b, l = tokens.shape
    if l % chunk:
        chunk = l
    outs = []
    for j in range(0, l, chunk):
        tok = tokens[:, j:j + chunk].long()
        oh = torch.zeros((b, tok.shape[1], w.shape[0]), dtype=w.dtype,
                         device=w.device).scatter_(-1, tok[..., None], 1.0)
        outs.append(matmul_acc(oh, w).to(w.dtype))
    return torch.cat(outs, dim=1)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(…, d) -> (…, V) logits in ``pet()`` (fp32: bf16 operands
    multiplied in fp32, with no fp32 copy of the table)."""
    return matmul_acc(x, p["w"].t())


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, computed in float64 and used in
    fp32 as the reference's numpy constant is; made on ``device`` (no
    host-to-device copy, which would wait for the device)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64,
                        device=device) / head_dim
    return (1.0 / theta ** exps).to(torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, L, H, D); positions: (B, L)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * inv           # (B, L, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, L, H, D); positions: (3, B, L),
    the temporal, height and width streams; ``sections`` splits the D/2
    frequency slots among the streams in order (e.g. (16, 24, 24) for
    D = 128): slot i turns with the position of its stream."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {sections} must sum to {d // 2}")
    inv = rope_freqs(d, theta, x.device)                        # (D/2,)
    parts, start = [], 0
    for i, n in enumerate(sections):      # stream i drives n slots in turn
        parts.append(positions[i][..., None].float() * inv[start:start + n])
        start += n
    ang = torch.cat(parts, dim=-1)                              # (B, L, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          mrope_sections: tuple[int, ...]) -> torch.Tensor:
    if mrope_sections:
        return apply_mrope(x, positions, theta, mrope_sections)
    return apply_rope(x, positions, theta)


# --------------------------------------------------------------------------
# attention (GQA, RoPE or M-RoPE, optional QKV bias and qk-norm; causal or
# full self-attention, cross-attention)
# --------------------------------------------------------------------------

def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                   device: torch.device, qkv_bias: bool = False,
                   qk_norm: bool = False) -> Params:
    s_q = 1.0 / math.sqrt(d_model)
    s_o = 1.0 / math.sqrt(n_heads * head_dim)
    p: Params = {
        "wq": normal(generator, (d_model, n_heads, head_dim), s_q, dtype, device),
        "wk": normal(generator, (d_model, n_kv_heads, head_dim), s_q, dtype, device),
        "wv": normal(generator, (d_model, n_kv_heads, head_dim), s_q, dtype, device),
        "wo": normal(generator, (n_heads, head_dim, d_model), s_o, dtype, device),
    }
    if qkv_bias:
        for name, heads in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
            p[name] = torch.zeros((heads, head_dim), dtype=dtype, device=device)
    if qk_norm:
        p["q_norm"] = init_rms_norm(head_dim, dtype, device)
        p["k_norm"] = init_rms_norm(head_dim, dtype, device)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bld,dhk->blhk") rounded to x's dtype."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k).to(x.dtype)).unflatten(-1, (h, k))


def _project_q(p: Params, x: torch.Tensor, positions: torch.Tensor,
               theta: float, qk_norm: bool = False, eps: float = 1e-6,
               mrope_sections: tuple[int, ...] = ()) -> torch.Tensor:
    """q (B, L, H, D) in the reference's order: the projection rounded to
    x's dtype, the bias added, qk-norm, RoPE (or M-RoPE)."""
    q = _heads(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if qk_norm:
        q = rms_norm(p["q_norm"], q, eps)
    return _rope(q, positions, theta, mrope_sections)


def prefill_attention_kv(p: Params, x: torch.Tensor, positions: torch.Tensor,
                         *, theta: float, qk_norm: bool = False,
                         eps: float = 1e-6,
                         mrope_sections: tuple[int, ...] = ()
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """k, v (B, L, KV, D) of ``x`` at ``positions``, k rotated: what a cache
    holds, and the encoder memory's keys and values for cross-attention."""
    k, v = _heads(x, p["wk"]), _heads(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if qk_norm:
        k = rms_norm(p["k_norm"], k, eps)
    return _rope(k, positions, theta, mrope_sections), v


def _project_qkv(p: Params, x: torch.Tensor, positions: torch.Tensor,
                 theta: float, qk_norm: bool = False, eps: float = 1e-6,
                 mrope_sections: tuple[int, ...] = ()
                 ) -> tuple[torch.Tensor, ...]:
    """q (B, L, H, D), k, v (B, L, KV, D)."""
    q = _project_q(p, x, positions, theta, qk_norm, eps, mrope_sections)
    k, v = prefill_attention_kv(p, x, positions, theta=theta, qk_norm=qk_norm,
                                eps=eps, mrope_sections=mrope_sections)
    return q, k, v


def _out_proj(p: Params, out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """einsum("blhd,hdm->blm") rounded to ``dtype``."""
    h, d, m = p["wo"].shape
    return torch.matmul(out.flatten(-2), p["wo"].reshape(h * d, m).to(dtype))


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """q: (B, Lq, H, D); k, v: (B, Lk, KV, D); mask broadcast to
    (B, KV, G, Lq, Lk).  GQA by head grouping; softmax in fp32, weights
    rounded to v's dtype before the PV product."""
    b, lq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, lq, kv, g, d)
    logits = torch.einsum("blkgd,bmkd->bkglm", qg.float(), k.float())
    logits = logits / math.sqrt(d)
    logits = torch.where(mask, logits, torch.full((), -1e30,
                                                  device=logits.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkglm,bmkd->blkgd", w.to(v.dtype).float(), v.float())
    return out.reshape(b, lq, h, d).to(q.dtype)


# Above this many score elements, causal self-attention on the plain path
# switches to the kv-chunked online softmax (the reference's
# _CHUNKED_SDPA_THRESHOLD and _SDPA_CHUNK).
CHUNKED_SDPA_THRESHOLD = 4096 * 4096
SDPA_CHUNK = 1024


def _chunk_scores(q, kb, rows, ci: int, scale: float) -> torch.Tensor:
    """Scaled scores (E, G·Lq, chunk) fp32 of chunk ``ci``, -1e30 where the
    key lies after the query."""
    chunk = kb.shape[1]
    s = bmm_fp32(q, kb.transpose(1, 2)) * scale
    cols = ci * chunk + torch.arange(chunk, device=q.device)
    return torch.where(rows[:, None] >= cols[None, :], s,
                       torch.full((), -1e30, device=q.device))


def _grouped(t: torch.Tensor, kv: int) -> torch.Tensor:
    """(B, L, KV·G, D) -> (B·KV, G·L, D), rows ordered (g, l)."""
    b, l, h, d = t.shape
    return (t.reshape(b, l, kv, h // kv, d).permute(0, 2, 3, 1, 4)
            .reshape(b * kv, (h // kv) * l, d))


def _ungrouped(t: torch.Tensor, b: int, l: int, kv: int) -> torch.Tensor:
    """(B·KV, G·L, D) -> (B, L, KV·G, D), the inverse of ``_grouped``."""
    d = t.shape[-1]
    g = t.shape[1] // l
    return (t.reshape(b, kv, g, l, d).permute(0, 3, 1, 2, 4)
            .reshape(b, l, kv * g, d))


def _kv_chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, Lk, KV, D) -> (NC, B·KV, chunk, D)."""
    b, lk, kv, d = t.shape
    return (t.reshape(b, lk // chunk, chunk, kv, d).permute(1, 0, 3, 2, 4)
            .reshape(lk // chunk, b * kv, chunk, d))


class _SdpaChunkedCausal(torch.autograd.Function):
    """The reference's ``_sdpa_chunked_causal``: causal attention by an
    online softmax over key chunks, q (B, L, H, D), k, v (B, L, KV, D)
    with GQA.  The forward keeps (m, l, acc) per query row in fp32; the
    backward recomputes each chunk's probabilities from the saved
    log-sum-exp (flash-style) instead of holding O(L²) residuals.  Each
    product has the reference's operand and output dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, chunk):
        b, l, h, d = q.shape
        kv = k.shape[2]
        scale = 1.0 / math.sqrt(d)
        qg = _grouped(q, kv)                              # (E, G·L, D)
        rows = torch.arange(l, device=q.device).repeat(h // kv)
        m = torch.full(qg.shape[:2], -1e30, device=q.device)
        den = torch.zeros(qg.shape[:2], device=q.device)
        acc = torch.zeros(qg.shape, device=q.device)
        for ci, (kb, vb) in enumerate(zip(_kv_chunks(k, chunk),
                                          _kv_chunks(v, chunk))):
            s = _chunk_scores(qg, kb, rows, ci, scale)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            den = den * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + bmm_fp32(p.to(vb.dtype), vb)
            m = m_new
        out = _ungrouped(acc / den[..., None], b, l, kv).to(q.dtype)
        lse = m + torch.log(den)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        chunk = ctx.chunk
        b, l, h, d = q.shape
        kv = k.shape[2]
        scale = 1.0 / math.sqrt(d)
        qg = _grouped(q, kv)
        og = _grouped(dout.float(), kv)
        delta = (_grouped(out.float(), kv) * og).sum(-1)  # (E, G·L)
        rows = torch.arange(l, device=q.device).repeat(h // kv)
        dq = torch.zeros(qg.shape, device=q.device)
        dks, dvs = [], []
        for ci, (kb, vb) in enumerate(zip(_kv_chunks(k, chunk),
                                          _kv_chunks(v, chunk))):
            p = torch.exp(_chunk_scores(qg, kb, rows, ci, scale)
                          - lse[..., None])
            dvs.append(bmm_fp32(p.transpose(1, 2), og))
            dp = bmm_fp32(og.to(vb.dtype), vb.transpose(1, 2))
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + bmm_fp32(ds.to(kb.dtype), kb)
            dks.append(bmm_fp32(ds.to(q.dtype).transpose(1, 2), qg))

        def keys(parts, like):                 # (NC, E, chunk, D) -> k's
            t = torch.stack(parts).reshape(l // chunk, b, kv, chunk, d)
            return t.permute(1, 0, 3, 2, 4).reshape(b, l, kv, d).to(like.dtype)

        return (_ungrouped(dq, b, l, kv).to(q.dtype), keys(dks, k),
                keys(dvs, v), None)


def attention(p: Params, x: torch.Tensor, positions: torch.Tensor, *,
              theta: float, qk_norm: bool = False, eps: float = 1e-6,
              mrope_sections: tuple[int, ...] = (),
              kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
              causal: bool = True, window: int = 0, mode: str | None = None,
              chunk_threshold: int = CHUNKED_SDPA_THRESHOLD):
    """Full-sequence (prefill) attention through the flash kernel.  x:
    (B, L, d); positions: (B, L), or (3, B, L) with ``mrope_sections``.
    Returns (y (B, L, d), (k, v)): the keys and values (B, Lk, KV, D)
    attended, which for self-attention are what a cache holds (the
    reference's ``prefill_attention_kv`` computes them with a second
    projection).  A causal self-attention with ``window`` > 0 keeps key k
    for query q where q - window < k <= q.  With ``kv_override`` = (k, v)
    it is cross-attention: only the queries are projected, and the mask is
    all-true whatever ``causal`` and ``window`` say, as the reference's.
    On the plain path (``mode="ref"``) a causal self-attention with no
    window inside the sequence, Lq = Lk a multiple of ``SDPA_CHUNK`` and
    Lq·Lk > ``chunk_threshold`` runs the reference's kv-chunked twin."""
    if kv_override is None:
        q, k, v = _project_qkv(p, x, positions, theta, qk_norm, eps,
                               mrope_sections)
        window = window if causal else 0
    else:
        q = _project_q(p, x, positions, theta, qk_norm, eps, mrope_sections)
        (k, v), causal, window = kv_override, False, 0
    lq, lk = q.shape[1], k.shape[1]
    if (mode == "ref" and causal and kv_override is None
            and (window == 0 or window >= lk) and lq == lk
            and lq * lk > chunk_threshold and lk % SDPA_CHUNK == 0):
        out = _SdpaChunkedCausal.apply(q, k, v, SDPA_CHUNK)
        return _out_proj(p, out, x.dtype), (k, v)
    # (B, L, H, D) -> (B, H, L, D) views; the kernel reads them strided and
    # maps each query head to its KV head itself
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              mode=mode)
    y = _out_proj(p, out.transpose(1, 2), x.dtype)
    return y, (k, v)


def decode_attention(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_len: torch.Tensor,
                     positions: torch.Tensor, *, theta: float,
                     qk_norm: bool = False, eps: float = 1e-6,
                     mrope_sections: tuple[int, ...] = (),
                     window: int = 0, write_pos: torch.Tensor | None = None):
    """One decode step.  x: (B, 1, d); cache_k/v: (B, S, KV, D); cache_len:
    (B,).  Writes the new k, v into the caches IN PLACE at ``write_pos``
    (default ``cache_len``; no copy of the cache per step).  A ring
    buffer's ``write_pos`` lies in the cache; at ``cache_len`` >= S a row
    writes nothing, as the reference's ``mode="drop"`` scatter.  Attends
    over every position <= ``cache_len`` (and > ``cache_len - window`` when
    ``window``).  Returns (y, cache_k, cache_v)."""
    q, k, v = _project_qkv(p, x, positions, theta, qk_norm, eps,
                           mrope_sections)
    s = cache_k.shape[1]
    rows = torch.arange(x.shape[0], device=x.device)
    if write_pos is not None:
        slot = write_pos.long()
        cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
    else:
        # a dropped row rewrites its clamped slot's old value: no host sync
        keep = (cache_len < s)[:, None, None]
        slot = cache_len.long().clamp(max=s - 1)
        for cache, new in ((cache_k, k), (cache_v, v)):
            cache[rows, slot] = torch.where(keep, new[:, 0].to(cache.dtype),
                                            cache[rows, slot])
    idx = torch.arange(s, device=x.device)[None, :]
    mask = idx <= cache_len[:, None]
    if window > 0:
        mask &= idx > cache_len[:, None] - window
    out = _sdpa(q, cache_k, cache_v, mask[:, None, None, None, :])
    return _out_proj(p, out, x.dtype), cache_k, cache_v


def decode_cross_attention(p: Params, x: torch.Tensor, mem_k: torch.Tensor,
                           mem_v: torch.Tensor, positions: torch.Tensor, *,
                           theta: float, qk_norm: bool = False,
                           eps: float = 1e-6) -> torch.Tensor:
    """One decode step's cross-attention.  x: (B, 1, d) rotated by
    ``positions`` (B, 1); mem_k, mem_v: (B, Sm, KV, D), the encoder
    memory's keys and values computed at prefill.  Every memory position is
    attended (the reference's ``attention(..., kv_override=...)`` on one
    token, in plain PyTorch)."""
    q = _project_q(p, x, positions, theta, qk_norm, eps)
    mask = torch.ones((1, 1, 1, 1, mem_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    return _out_proj(p, _sdpa(q, mem_k, mem_v, mask), x.dtype)


# --------------------------------------------------------------------------
# MLP (SwiGLU)
# --------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype, device: torch.device) -> Params:
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": normal(generator, (d_model, d_ff), s_in, dtype, device),
        "w_up": normal(generator, (d_model, d_ff), s_in, dtype, device),
        "w_down": normal(generator, (d_ff, d_model), s_out, dtype, device),
    }


def gemm_f32_grads(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, op,
                   need_x: bool = True, need_w: bool = True):
    """(dx, dw) of ``op(x, w)`` (torch.mm or torch.bmm, bf16 operands) for
    its fp32 cotangent ``g``, in the operands' dtype: ``g`` split into
    bf16 hi + lo, each product two bf16 GEMMs with fp32 output, summed
    and rounded once."""
    hi = g.to(x.dtype)
    lo = (g - hi.float()).to(x.dtype)

    def prod(a, b, c, d):
        return (op(a, b, out_dtype=torch.float32)
                + op(c, d, out_dtype=torch.float32)).to(x.dtype)

    wt, xt = w.transpose(-1, -2), x.transpose(-1, -2)
    return (prod(hi, wt, lo, wt) if need_x else None,
            prod(xt, hi, xt, lo) if need_w else None)


class _GemmF32(torch.autograd.Function):
    """``op`` (torch.mm or torch.bmm) of two bf16 operands written in fp32
    by one GEMM; backward: ``gemm_f32_grads``."""

    @staticmethod
    def forward(ctx, x, w, op):
        ctx.save_for_backward(x, w)
        ctx.op = op
        return op(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx, gw = gemm_f32_grads(x, w, g, ctx.op, *ctx.needs_input_grad[:2])
        return gx, gw, None


def matmul_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with w in x's dtype, accumulated and returned in fp32 (the
    reference's ``preferred_element_type=float32`` left unrounded).  On the
    card a bf16 GEMM writes fp32 directly (``_GemmF32``); on the CPU, which
    has no such GEMM, the fp32 product of the upcast operands is the same
    arithmetic: bf16 products are exact in fp32."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32 or x.device.type == "cpu":
        return torch.matmul(x.float(), w.float())
    out = _GemmF32.apply(x.reshape(-1, x.shape[-1]), w, torch.mm)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def bmm_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched ``matmul_fp32``: (E, M, K) @ (E, K, N) with w in x's dtype,
    accumulated and returned in fp32 (``_GemmF32`` of ``torch.bmm`` on the
    card, the upcast operands on the CPU)."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32 or x.device.type == "cpu":
        return torch.bmm(x.float(), w.float())
    return _GemmF32.apply(x, w, torch.bmm)


def matmul_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with w in x's dtype, returned in ``pet()``: ``matmul_fp32``
    under the default fp32; otherwise the product in x's dtype (one GEMM,
    fp32 accumulation inside) cast to ``pet()``."""
    if pet() == torch.float32:
        return matmul_fp32(x, w)
    return torch.matmul(x, w.to(x.dtype)).to(pet())


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: the gate and up products stay in ``pet()`` (fp32 by
    default) until silu(g)·u is rounded to x's dtype, as in the
    reference."""
    g = matmul_acc(x, p["w_gate"])
    u = matmul_acc(x, p["w_up"])
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return torch.matmul(h, p["w_down"].to(x.dtype))


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None, *,
                       mode: str | None = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32 (0-d).  logits (B, L, V) fp32 or
    bf16, labels (B, L); with ``mask`` (B, L), the masked mean
    Σ nll·mask / max(Σ mask, 1).  The (B·L, V) rows go through
    ``ops.softmax_xent`` (K4 forward, K5 backward on the card)."""
    v = logits.shape[-1]
    return ops.softmax_xent(
        logits.reshape(-1, v), labels.reshape(-1).to(torch.int32),
        None if mask is None else mask.reshape(-1), mode=mode)


def fused_unembed_ce(emb: Params, h: torch.Tensor, labels: torch.Tensor,
                     chunk: int = 512, *,
                     mode: str | None = None) -> torch.Tensor:
    """Unembedding and cross-entropy chunked over length, so no (B, L, V)
    logits tensor is held: each (B, chunk, V) slab is computed, reduced to
    its summed nll and dropped, under ``torch.utils.checkpoint`` so that
    the backward recomputes it (the reference's scan over chunks, the
    Megatron fused-loss pattern).  Falls back to the plain loss when the
    length is not a multiple of ``chunk``, as the reference does."""
    b, l, _ = h.shape
    if l % chunk:
        return cross_entropy_loss(unembed(emb, h), labels, mode=mode)

    def chunk_sum(h_c: torch.Tensor, lab_c: torch.Tensor) -> torch.Tensor:
        rows = lab_c.numel()
        # fp32 logits whatever pet(), as the reference's fused loss
        logits = matmul_fp32(h_c, emb["w"].t())
        return cross_entropy_loss(logits, lab_c, mode=mode) * rows

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(0, l, chunk):
        total = total + checkpoint(chunk_sum, h[:, j:j + chunk],
                                   labels[:, j:j + chunk],
                                   use_reentrant=False)
    return total / (b * l)


# --------------------------------------------------------------------------
# activation checkpointing
# --------------------------------------------------------------------------

# products without batch dimensions (what jax's
# ``dots_with_no_batch_dims_saveable`` keeps): a 2-D GEMM, whatever the
# overload (fp32 output included); a bmm has a batch dimension
_NO_BATCH_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm)


def _save_dots(ctx, op, *args, **kwargs):
    if getattr(op, "_overloadpacket", op) in _NO_BATCH_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(cfg, body: Callable) -> Callable:
    """The configured activation-checkpoint policy around ``body`` (a
    layer), as the reference wraps its scan body: ``cfg.remat`` off,
    ``body`` itself; policy ``"full"``, nothing of the body saved for the
    backward (its inputs aside), everything recomputed; ``"dots"``, the
    outputs of products without batch dimensions saved, the rest
    recomputed."""
    if not cfg.remat:
        return body
    if getattr(cfg, "remat_policy", "full") == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _save_dots)
    else:
        context_fn = None

    def wrapped(*args, **kwargs):
        if context_fn is None:
            return checkpoint(body, *args, use_reentrant=False, **kwargs)
        return checkpoint(body, *args, use_reentrant=False,
                          context_fn=context_fn, **kwargs)
    return wrapped
