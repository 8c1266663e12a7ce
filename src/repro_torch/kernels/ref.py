"""Plain PyTorch versions of the seven kernels: the five of the FCNN
training step and the two of the LM prefill (flash attention, the SSD
intra-chunk term), and of the two backward kernels of the LM training
step: flash attention's (with the forward's log-sum-exp) and the SSD
intra-chunk term's.

Each function computes what its CUDA kernel computes, with PyTorch ops in
fp32.  The kernel wrappers run these for tensors on the CPU, ``ops``
runs them (under autograd) for ``mode="ref"``, and ``chip_smoke.py``
holds each kernel against its plain version on the card.  Counterparts:
``repro/kernels/ref.py`` in the JAX reference.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "ACTIVATIONS",
    "act_deriv_from_output",
    "apply_activation",
    "fcnn_layer_ref",
    "fcnn_layer_dgrad_ref",
    "fcnn_layer_wgrad_ref",
    "softmax_xent_fwd_ref",
    "softmax_xent_dlogits_ref",
    "flash_attention_ref",
    "flash_attention_lse_ref",
    "flash_attention_bwd_ref",
    "attention_mask",
    "check_causal_lengths",
    "ssd_chunk_ref",
    "ssd_chunk_bwd_ref",
]

ACTIVATIONS = ("sigmoid", "relu", "tanh", "none")


def apply_activation(z: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "sigmoid":
        return torch.sigmoid(z)
    if activation == "relu":
        return torch.relu(z)
    if activation == "tanh":
        return torch.tanh(z)
    if activation == "none":
        return z
    raise ValueError(f"unknown activation {activation!r}")


def act_deriv_from_output(y: torch.Tensor, activation: str) -> torch.Tensor:
    """A'(z) expressed via the activation output y (fp32 in, fp32 out).

    The one table of derivatives: the CUDA kernels' ``act_deriv`` in
    ``csrc/fcnn_act.cuh`` implements the same four lines."""
    if activation == "sigmoid":
        return y * (1.0 - y)
    if activation == "relu":
        return (y > 0).to(torch.float32)
    if activation == "tanh":
        return 1.0 - y * y
    if activation == "none":
        return torch.ones_like(y)
    raise ValueError(f"unknown activation {activation!r}")


def _dz(dy: torch.Tensor, y: torch.Tensor, activation: str) -> torch.Tensor:
    return dy.float() * act_deriv_from_output(y.float(), activation)


def fcnn_layer_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   activation: str = "sigmoid") -> torch.Tensor:
    """One FCNN period: act(x @ w + b).  x: (M, K), w: (K, N), b: (N,)."""
    z = x.float() @ w.float() + b.float()
    return apply_activation(z, activation).to(x.dtype)


def fcnn_layer_dgrad_ref(dy: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                         activation: str = "sigmoid") -> torch.Tensor:
    """dX = (dY ⊙ A'(Y)) @ Wᵀ.  dy, y: (M, N); w: (K, N) -> (M, K)."""
    return (_dz(dy, y, activation) @ w.float().T).to(dy.dtype)


def fcnn_layer_wgrad_ref(x: torch.Tensor, dy: torch.Tensor, y: torch.Tensor,
                         activation: str = "sigmoid"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dW, db) = (Xᵀ @ dZ, Σ_rows dZ).  x: (M, K); dy, y: (M, N)."""
    dz = _dz(dy, y, activation)
    return (x.float().T @ dz).to(x.dtype), dz.sum(0).to(dy.dtype)


def softmax_xent_fwd_ref(logits: torch.Tensor, labels: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row cross-entropy of fp32 or bf16 logits, computed in fp32:
    (nll, lse), both (B,), with nll[r] = lse[r] − logits[r, labels[r]],
    and the batch mean of nll (0-d)."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    picked = x.gather(1, labels.long()[:, None])[:, 0]
    nll = lse - picked
    return nll, lse, nll.mean()


def softmax_xent_dlogits_ref(logits: torch.Tensor, labels: torch.Tensor,
                             lse: torch.Tensor,
                             scale: torch.Tensor | None = None, *,
                             g: torch.Tensor | None = None) -> torch.Tensor:
    """dlogits = (exp(logits − lse) − onehot(labels)) · s[:, None] in the
    logits' dtype, with s = ``scale`` (B,) or, for the loss cotangent ``g``
    (0-d), s = g / B."""
    x = logits.float()
    p = torch.exp(x - lse[:, None])
    onehot = torch.nn.functional.one_hot(labels.long(), x.shape[1]).float()
    s = scale[:, None] if scale is not None else g.float() / x.shape[0]
    return ((p - onehot) * s).to(logits.dtype)


def check_causal_lengths(sq: int, sk: int, causal: bool,
                         window: int = 0) -> None:
    """Causal attention needs as many keys as queries: the reference asks
    for no other causal case (its cross-attention is not causal), and the
    kernel takes none.  A sliding window (``window`` > 0) is a causal
    mask's: ``window`` >= 0, and > 0 only where causal."""
    if causal and sq != sk:
        raise ValueError(f"flash_attention: causal attention needs Sq == Sk, "
                         f"got Sq = {sq}, Sk = {sk} (cross-attention is not "
                         f"causal)")
    if window < 0 or (window and not causal):
        raise ValueError(f"flash_attention: window = {window}: needs "
                         f"window >= 0, and a window only where causal")


def attention_mask(sq: int, sk: int, window: int,
                   device: torch.device) -> torch.Tensor:
    """(Sq, Sk) bool, the causal mask: key k kept for query q where
    k <= q, and q - window < k where ``window`` > 0 (the reference's
    ``attention`` mask)."""
    iq = torch.arange(sq, device=device)[:, None]
    ik = torch.arange(sk, device=device)[None, :]
    mask = ik <= iq
    if window > 0:
        mask &= ik > iq - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D), k, v: (B, KV, Sk, D) with H % KV == 0 (Sk = Sq
    where causal) -> (B, H, Sq, D) in q's dtype; query head h reads KV head
    h // (H // KV) (GQA by head grouping, K and V not repeated); softmax in
    fp32, probabilities rounded to v's dtype before the PV product.  Where
    causal, ``window`` > 0 keeps only the ``window`` most recent keys of
    each query (``attention_mask``).  Handed float64 inputs it computes
    in float64 (``_up``)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    check_causal_lengths(sq, sk, causal, window)
    qg = _up(q).reshape(b, kv, h // kv, sq, d)
    s = torch.einsum("bkgqd,bkmd->bkgqm", qg, _up(k)) / math.sqrt(d)
    if causal:
        mask = attention_mask(sq, sk, window, q.device)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqm,bkmd->bkgqd", _up(p.to(v.dtype)), _up(v))
    return o.reshape(b, h, sq, d).to(q.dtype)


def _up(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or as it is where it is float64: the plain versions
    of K6, K7 and their backwards run in float64 when handed float64
    inputs (chip_smoke.py phase 7's witness of the fp32 kernels'
    accuracy)."""
    return t if t.dtype == torch.float64 else t.float()


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    """Scaled scores (B, KV, G, Sq, Sk) fp32 of q (B, H, Sq, D) against k
    (B, KV, Sk, D), -1e30 where the mask drops the key (the reference's
    ``_flash_fwd_core`` and ``_sdpa_chunked_bwd``)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = _up(q).reshape(b, kv, h // kv, sq, d)
    s = torch.einsum("bkgqd,bkmd->bkgqm", qg, _up(k)) * (1.0 / math.sqrt(d))
    if causal:
        mask = attention_mask(sq, sk, window, q.device)
        s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    return s


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): ``flash_attention_ref``'s output and each query row's
    log-sum-exp (B, H, Sq) fp32 of its scaled scores, m + log(l) in
    natural-log units, as the reference's ``_flash_fwd_core`` returns it."""
    b, h, sq, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal, window), dim=-1)
    return (flash_attention_ref(q, k, v, causal, window),
            lse.reshape(b, h, sq))


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            dout: torch.Tensor, lse: torch.Tensor,
                            causal: bool = True, window: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_ref`` for the cotangent ``dout``
    (q's shape), from the forward's ``o`` and ``lse`` (B, H, Sq), in the
    reference's ``_sdpa_chunked_bwd`` arithmetic and roundings, over any
    mask ``attention_mask`` gives and GQA: p = exp(s − lse) in fp32,
    delta = Σ o·dO, dV = pᵀ·dO with p and dO in fp32, dP = dO·vᵀ, dS =
    p·(dP − delta)·scale rounded to q's dtype for dQ = dS·k and dK =
    dSᵀ·q; every product accumulates in fp32, and the gradients are
    rounded once to q's, k's and v's dtypes.  Handed float64 inputs it
    computes in float64 (``_up``)."""
    b, h, sq, d = q.shape
    kv = k.shape[1]
    check_causal_lengths(sq, k.shape[2], causal, window)
    g = h // kv
    scale = 1.0 / math.sqrt(d)

    def grouped(t):
        return _up(t).reshape(b, kv, g, sq, d)

    og = grouped(dout)
    delta = (grouped(o) * og).sum(-1)                          # (B, KV, G, Sq)
    p = torch.exp(_scores(q, k, causal, window)
                  - _up(lse).reshape(b, kv, g, sq)[..., None])
    dv = torch.einsum("bkgqm,bkgqd->bkmd", p, og)
    dp = torch.einsum("bkgqd,bkmd->bkgqm", _up(og.to(v.dtype)), _up(v))
    ds = _up((p * (dp - delta[..., None]) * scale).to(q.dtype))
    dq = torch.einsum("bkgqm,bkmd->bkgqd", ds, _up(k))
    dk = torch.einsum("bkgqm,bkgqd->bkmd", ds, grouped(q))
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def ssd_chunk_ref(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD for a batch of chunks (the reference's per-chunk
    oracle mapped over the leading axis).

    x: (BC, Q, H, P); dt_a: (BC, Q, H); b, c: (BC, Q, H, N) (groups
    broadcast to heads; stride-0 views are fine).  Returns
    (y_diag (BC, Q, H, P) in x's dtype, chunk_state (BC, H, P, N) fp32,
    decay_out (BC, Q, H) fp32):
      y_diag[t]    = sum_{s<=t} C_t·B_s exp(cs_t − cs_s) x_s
      chunk_state  = sum_s exp(cs_{Q-1} − cs_s) B_s x_sᵀ
      decay_out[t] = exp(cs_t),   cs = cumsum(dt_a) in fp32
    Handed float64 inputs it computes in float64 (``_up``).
    """
    q = x.shape[1]
    xf, bf, cf = _up(x), _up(b), _up(c)
    cs = torch.cumsum(_up(dt_a), dim=1)                        # (BC, Q, H)
    seg = cs[:, :, None, :] - cs[:, None, :, :]                # (BC, Q, Q, H)
    # exp of the segment sums masked to -inf above the diagonal (0 there):
    # unmasked, exp(seg) there can overflow, and its gradient would be
    # 0·inf under autograd, as the reference's segsum avoids
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(seg.masked_fill(~mask[None, :, :, None], float("-inf")))
    scores = torch.einsum("bthn,bshn->btsh", cf, bf)
    y = torch.einsum("btsh,bshp->bthp", scores * lmat, xf)
    decay_state = torch.exp(cs[:, -1:, :] - cs)                # (BC, Q, H)
    state = torch.einsum("bshn,bsh,bshp->bhpn", bf, decay_state, xf)
    return y.to(x.dtype), state, torch.exp(cs)


def ssd_chunk_bwd_ref(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, dy: torch.Tensor | None,
                      dstate: torch.Tensor | None,
                      ddecay: torch.Tensor | None, groups: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """(dx, d(dt_a), db, dc) of ``ssd_chunk_ref`` for the cotangents ``dy``
    (y's shape), ``dstate`` (BC, H, P, N) and ``ddecay`` (BC, Q, H), any of
    which may be None (zero).  Per (chunk, head), with cs = cumsum(dt_a),
    L[t,s] = exp(cs_t − cs_s) on s <= t (0 above), S = C·Bᵀ, w_s =
    exp(cs_{Q-1} − cs_s) and dec = exp(cs):

      dM = dy·xᵀ, dS = dM∘L       (L masked before exp: no 0·inf)
      dx = (S∘L)ᵀ·dy + w∘(B·dstᵀ)
      dC = dS·B,  dB = dSᵀ·C + w∘(x·dst)
      dcs_t = Σ_s (dS∘S)[t,s] − Σ_s (dS∘S)[s,t] − dw_t·w_t + ddec_t·dec_t,
              plus Σ_s dw_s·w_s at t = Q−1, with dw_s = x_sᵀ·dst·B_s
      d(dt_a) = the reverse cumsum of dcs over the chunk.

    Everything in fp32; db and dc are summed over each of ``groups``
    consecutive-head groups (None: one a head) into (BC, Q, G, N) in fp32,
    and each gradient is rounded once to its input's dtype (d(dt_a) fp32):
    ordinary autograd through ``ssd_chunk_ref`` up to fp32 sum orders.
    Handed float64 inputs it computes in float64 (``_up``)."""
    bc, q, h, p = x.shape
    n = b.shape[-1]
    g = h if groups is None else groups
    xf, bf, cf = _up(x), _up(b), _up(c)
    cs = torch.cumsum(_up(dt_a), dim=1)                        # (BC, Q, H)
    seg = cs[:, :, None, :] - cs[:, None, :, :]                # (BC, Q, Q, H)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(seg.masked_fill(~mask[None, :, :, None], float("-inf")))
    scores = torch.einsum("bthn,bshn->btsh", cf, bf)
    w = torch.exp(cs[:, -1:, :] - cs)                          # (BC, Q, H)
    dx = torch.zeros((bc, q, h, p), dtype=xf.dtype, device=x.device)
    db = torch.zeros((bc, q, h, n), dtype=xf.dtype, device=x.device)
    dc = torch.zeros_like(db)
    dcs = torch.zeros_like(cs)
    if dy is not None:
        dyf = _up(dy)
        ds = torch.einsum("bthp,bshp->btsh", dyf, xf) * lmat
        dx += torch.einsum("btsh,bthp->bshp", scores * lmat, dyf)
        dc += torch.einsum("btsh,bshn->bthn", ds, bf)
        db += torch.einsum("btsh,bthn->bshn", ds, cf)
        r = ds * scores
        dcs += r.sum(2) - r.sum(1)
    if dstate is not None:
        dst = _up(dstate)
        dx += w[..., None] * torch.einsum("bshn,bhpn->bshp", bf, dst)
        xdst = torch.einsum("bshp,bhpn->bshn", xf, dst)
        db += w[..., None] * xdst
        dww = (xdst * bf).sum(-1) * w                          # dw_s·w_s
        dcs -= dww
        dcs[:, -1] += dww.sum(1)
    if ddecay is not None:
        dcs += _up(ddecay) * torch.exp(cs)
    ddt = torch.flip(torch.cumsum(torch.flip(dcs, (1,)), dim=1), (1,))
    if g != h:
        db = db.reshape(bc, q, g, h // g, n).sum(3)
        dc = dc.reshape(bc, q, g, h // g, n).sum(3)
    return dx.to(x.dtype), ddt, db.to(b.dtype), dc.to(c.dtype)
