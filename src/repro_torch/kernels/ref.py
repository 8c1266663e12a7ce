"""Plain PyTorch versions of the seven kernels: the five of the FCNN
training step and the two of the LM prefill (flash attention, the SSD
intra-chunk term).

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
    "check_causal_lengths",
    "ssd_chunk_ref",
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


def check_causal_lengths(sq: int, sk: int, causal: bool) -> None:
    """Causal attention needs as many keys as queries: the reference asks
    for no other causal case (its cross-attention is not causal), and the
    kernel takes none."""
    if causal and sq != sk:
        raise ValueError(f"flash_attention: causal attention needs Sq == Sk, "
                         f"got Sq = {sq}, Sk = {sk} (cross-attention is not "
                         f"causal)")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, D), k, v: (B, KV, Sk, D) with H % KV == 0 (Sk = Sq
    where causal) -> (B, H, Sq, D) in q's dtype; query head h reads KV head
    h // (H // KV) (GQA by head grouping, K and V not repeated); softmax in
    fp32, probabilities rounded to v's dtype before the PV product."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    check_causal_lengths(sq, sk, causal)
    qg = q.float().reshape(b, kv, h // kv, sq, d)
    s = torch.einsum("bkgqd,bkmd->bkgqm", qg, k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqm,bkmd->bkgqd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


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
    """
    q = x.shape[1]
    xf, bf, cf = x.float(), b.float(), c.float()
    cs = torch.cumsum(dt_a.float(), dim=1)                     # (BC, Q, H)
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
