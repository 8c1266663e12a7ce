"""Plain PyTorch training steps of the Granite 3.0 language models: the
benchmark's reference for the dense (granite-3.0-2b-base) and the mixture
of experts (granite-3.0-1b-a400m-base) configurations.

Written from the published architecture (Hugging Face ``GraniteForCausalLM``
and ``GraniteMoeForCausalLM``): a pre-norm decoder with RMSNorm, grouped-query
causal attention with rotary positions (rotate-half, ``rope_theta``), a SwiGLU
MLP or, in the MoE, top-k routed SwiGLU experts (softmax over the router's
logits, the top k renormalised, which equals a softmax over the top-k logits),
tied input and output embeddings and the four Granite multipliers (embedding,
attention scale, residual, logits).  A step is the mean token cross-entropy
over the batch, its gradients (the batch in ``microbatches`` parts, the mean
of their losses and gradients), clipping by the global norm and AdamW with
decoupled weight decay on every parameter, bias-corrected moments kept in
fp32 and each new parameter rounded once to the stored type.

The configuration file states what runs, and this follows it; where it
departs from the published model (``reduced`` in ``BENCHMARK.json``, and
``departures`` in the file) the departure is taken from the file:

* the multipliers, as the file gives them (1, 1/sqrt(head_dim), 1, 1 as run);
* the embedding table padded to a multiple of ``vocab_pad_multiple`` rows,
  the softmax over every row of it;
* the MoE's capacity: the microbatch's tokens in groups of
  ``moe_group_size``, each expert taking at most
  ceil(group * k / E * ``moe_capacity_factor``) of a group's tokens in token
  order, a token past that dropped at that expert (its gate kept in the
  renormalisation), equal router probabilities ordered by the lower expert
  index; and the router's load-balance loss, E * the mean over groups of
  sum_e (share of the group's tokens choosing e) * (mean probability of e),
  averaged over layers, times ``router_aux_loss_coef``, added to the loss;
* the parameters stored in ``param_dtype``.

Everything is computed in float32 (TF32 off), with the parameters read from
their stored values.  ``Precision`` names the arithmetic of the products:
``"fp32"`` is the reference; ``"fp8"`` rounds both operands of every product
to float8 e4m3 and its gradient to e5m2, each scaled by its tensor's largest
magnitude: the control, the nearest precision below the configuration's
bf16.  Memory: each layer is recomputed in the backward
(``torch.utils.checkpoint``) and attention runs over blocks of query rows, so
a step fits beside its fp32 state at the timed sizes.

This module imports nothing of the program under test; it names and
measures its leaves as the check does (``bench.check.leaf_norms``).
"""

from __future__ import annotations

import math
from typing import Iterator

import torch
from torch.utils.checkpoint import checkpoint

from bench.check import leaf_norms

__all__ = ["Precision", "param_spec", "padded_vocab", "make_params",
           "train_steps"]

Q_BLOCK = 1024          # query rows of one attention block
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


class _RoundFp8(torch.autograd.Function):
    """Forward: the operand rounded to e4m3 at its tensor's scale; backward:
    the gradient passed through (the rounding's straight-through estimate)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGradFp8(torch.autograd.Function):
    """Forward: identity; backward: the gradient rounded to e5m2 at its
    tensor's scale, as fp8 training sends a product's output gradient."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class Precision:
    """The arithmetic of every product: ``"fp32"`` (the reference) or
    ``"fp8"`` (the control)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b in fp32, each operand (and the gradient of the product)
        rounded as the precision says."""
        if self.name == "fp32":
            return a @ b
        return _RoundGradFp8.apply(_RoundFp8.apply(a) @ _RoundFp8.apply(b))


# ---------------------------------------------------------------- parameters

def padded_vocab(cfg: dict) -> int:
    m = cfg["run"]["vocab_pad_multiple"]
    return -(-cfg["vocab_size"] // m) * m


def _is_moe(cfg: dict) -> bool:
    return cfg.get("num_local_experts", 0) > 0


def param_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], torch.dtype,
                                        str]]:
    """(path, shape, stored dtype, init) of every parameter, in the order
    they are drawn.  Layer parameters are stacked on a leading layer axis;
    ``init`` is ``"normal"`` (N(0, initializer_range²)) or ``"ones"``."""
    d, n_l = cfg["hidden_size"], cfg["num_hidden_layers"]
    h, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    dt = getattr(torch, cfg["run"]["param_dtype"])
    spec = [("embedding/w", (padded_vocab(cfg), d), dt, "normal"),
            ("final_norm/scale", (d,), dt, "ones"),
            ("layers/ln1/scale", (n_l, d), dt, "ones"),
            ("layers/attn/wq", (n_l, d, h, hd), dt, "normal"),
            ("layers/attn/wk", (n_l, d, kv, hd), dt, "normal"),
            ("layers/attn/wv", (n_l, d, kv, hd), dt, "normal"),
            ("layers/attn/wo", (n_l, h, hd, d), dt, "normal"),
            ("layers/ln2/scale", (n_l, d), dt, "ones")]
    if _is_moe(cfg):
        e, f = cfg["num_local_experts"], cfg["intermediate_size"]
        router_dt = getattr(torch, cfg["run"]["router_dtype"])
        spec += [("layers/moe/router", (n_l, d, e), router_dt, "normal"),
                 ("layers/moe/w_gate", (n_l, e, d, f), dt, "normal"),
                 ("layers/moe/w_up", (n_l, e, d, f), dt, "normal"),
                 ("layers/moe/w_down", (n_l, e, f, d), dt, "normal")]
    else:
        f = cfg["intermediate_size"]
        spec += [("layers/mlp/w_gate", (n_l, d, f), dt, "normal"),
                 ("layers/mlp/w_up", (n_l, d, f), dt, "normal"),
                 ("layers/mlp/w_down", (n_l, f, d), dt, "normal")]
    if not cfg["tie_word_embeddings"]:
        spec.append(("unembed/w", (padded_vocab(cfg), d), dt, "normal"))
    return spec


def make_params(cfg: dict, seed: int,
                device: torch.device | str) -> Iterator[tuple[str,
                                                               torch.Tensor]]:
    """The parameters drawn from ``seed`` on ``device``, one stacked leaf at
    a time, in ``param_spec``'s order and type: each normal leaf one
    ``randn`` call of a generator on the device, scaled in place."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**64)
    std = cfg["initializer_range"]
    for path, shape, dtype, init in param_spec(cfg):
        if init == "ones":
            yield path, torch.ones(shape, dtype=dtype, device=device)
        else:
            t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
            yield path, t.mul_(std)


# --------------------------------------------------------------- the model

def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated by positions 0..S-1, rotate-half pairing."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None]
           * inv).float()
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention_block(q, k, v, i0: int, scale: float, prec: Precision):
    """Causal attention of query rows i0..i0+n over keys 0..i0+n: q (B, KV,
    G, n, D), k, v (B, KV, S, D)."""
    n = q.shape[3]
    kb, vb = k[:, :, :i0 + n], v[:, :, :i0 + n]
    s = prec.mm(q, kb[:, :, None].transpose(-1, -2)) * scale
    rows = torch.arange(i0, i0 + n, device=q.device)[:, None]
    cols = torch.arange(i0 + n, device=q.device)[None, :]
    s = s.masked_fill(cols > rows, float("-inf"))
    return prec.mm(torch.softmax(s, dim=-1), vb[:, :, None])


def _attention(p: dict, x: torch.Tensor, cfg: dict, prec: Precision):
    b, s, d = x.shape
    h, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    q = prec.mm(x, p["wq"].reshape(d, h * hd)).view(b, s, h, hd)
    k = prec.mm(x, p["wk"].reshape(d, kv * hd)).view(b, s, kv, hd)
    v = prec.mm(x, p["wv"].reshape(d, kv * hd)).view(b, s, kv, hd)
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    # (B, KV, G, S, D): query head j reads KV head j // G
    q = q.view(b, s, kv, h // kv, hd).permute(0, 2, 3, 1, 4)
    k, v = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    scale = cfg["attention_multiplier"]
    outs = []
    for i0 in range(0, s, Q_BLOCK):
        qb = q[:, :, :, i0:i0 + Q_BLOCK]
        if torch.is_grad_enabled() and s > Q_BLOCK:
            outs.append(checkpoint(_attention_block, qb, k, v, i0, scale,
                                   prec, use_reentrant=False))
        else:
            outs.append(_attention_block(qb, k, v, i0, scale, prec))
    o = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(b, s, h * hd)
    return prec.mm(o, p["wo"].reshape(h * hd, d))


def _swiglu(x, w_gate, w_up, w_down, prec: Precision) -> torch.Tensor:
    g = prec.mm(x, w_gate)
    return prec.mm(torch.nn.functional.silu(g) * prec.mm(x, w_up), w_down)


def _moe(p: dict, x: torch.Tensor, cfg: dict, prec: Precision):
    """(output (B, S, d), the layer's load-balance loss)."""
    b, s, d = x.shape
    e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    run = cfg["run"]
    n = b * s
    xs = x.reshape(n, d)
    g_size = min(run["moe_group_size"], n)
    if n % g_size:
        raise ValueError(f"{n} tokens do not fill groups of {g_size}")
    cap = max(1, math.ceil(g_size * k / e * run["moe_capacity_factor"]))
    probs = torch.softmax(prec.mm(xs, p["router"]), dim=-1)      # (n, E)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    gate = top_p / top_p.sum(-1, keepdim=True)                    # (n, k)
    chose = torch.zeros(n, e, device=x.device).scatter_(1, top_e, 1.0)
    grouped = chose.view(-1, g_size, e)
    # a token's place in its expert's queue: earlier tokens of the group
    # that chose the same expert
    place = (grouped.cumsum(1) - 1).view(n, e).gather(1, top_e)
    kept = place < cap
    aux = (grouped.mean(1) * probs.view(-1, g_size, e).mean(1)).sum(-1)
    aux = e * aux.mean()
    y = torch.zeros_like(xs)
    for j in range(e):
        tok, slot = torch.nonzero((top_e == j) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = _swiglu(xs[tok], p["w_gate"][j], p["w_up"][j], p["w_down"][j],
                      prec)
        y = y.index_add(0, tok, out * gate[tok, slot][:, None])
    return y.view(b, s, d), aux


def _layer(h: torch.Tensor, p: dict, cfg: dict, prec: Precision):
    eps, res = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    h = h + res * _attention(p["attn"], _rms_norm(h, p["ln1"], eps), cfg,
                             prec)
    x = _rms_norm(h, p["ln2"], eps)
    if _is_moe(cfg):
        y, aux = _moe(p["moe"], x, cfg, prec)
    else:
        m = p["mlp"]
        y = _swiglu(x, m["w_gate"], m["w_up"], m["w_down"], prec)
        aux = torch.zeros((), device=h.device)
    return h + res * y, aux


def _layer_params(w: dict, i: int) -> dict:
    """Layer ``i``'s parameters as a nested dict ("attn" -> "wq" -> view),
    a norm's scale under the norm's name."""
    out: dict = {}
    for path, t in w.items():
        parts = path.split("/")
        if parts[0] != "layers":
            continue
        if parts[-1] == "scale":
            out[parts[1]] = t[i]
        else:
            out.setdefault(parts[1], {})[parts[2]] = t[i]
    return out


def _loss(w: dict, tokens: torch.Tensor, labels: torch.Tensor, cfg: dict,
          prec: Precision) -> torch.Tensor:
    """Mean token cross-entropy plus the router's load-balance term; each
    layer recomputed in the backward."""
    emb = w["embedding/w"]
    h = emb[tokens.long()] * cfg["embedding_multiplier"]
    aux = torch.zeros((), device=h.device)
    for i in range(cfg["num_hidden_layers"]):
        lp = _layer_params(w, i)
        h, a = checkpoint(_layer, h, lp, cfg, prec, use_reentrant=False)
        aux = aux + a
    h = _rms_norm(h, w["final_norm/scale"], cfg["rms_norm_eps"])
    out_w = emb if cfg["tie_word_embeddings"] else w["unembed/w"]
    logits = prec.mm(h.reshape(-1, h.shape[-1]), out_w.t())
    logits = logits / cfg["logits_scaling"]
    loss = torch.nn.functional.cross_entropy(logits, labels.reshape(-1).long())
    if _is_moe(cfg):
        loss = loss + cfg["router_aux_loss_coef"] * aux / cfg[
            "num_hidden_layers"]
    return loss


# ---------------------------------------------------------------- training

def train_steps(cfg: dict, train: dict, seed: int, batches: list,
                device: torch.device | str, precision: str = "fp32",
                half_batch: bool = False) -> dict:
    """Run ``len(batches)`` steps from the parameters ``make_params(cfg,
    seed)`` gives, each batch a (tokens, labels) pair of (B, S) tensors.

    Returns ``losses`` (each step's loss), ``grad`` (per leaf, the norm of
    the first step's clipped gradient, as the optimizer takes it) and
    ``change`` (per leaf, the norm of the parameters' change over the
    steps).  ``half_batch`` plants a fault: the loss is the mean over the
    first half of each batch's rows alone (of its tokens, where the batch
    is one row)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prec = Precision(precision)
    stored = {path: dtype for path, _, dtype, _ in param_spec(cfg)}
    w, first = {}, {}
    for path, t in make_params(cfg, seed, device):
        first[path] = t
        w[path] = t.to(torch.float32, copy=True).requires_grad_(True)
    m = {p: torch.zeros_like(t) for p, t in w.items()}
    v = {p: torch.zeros_like(t) for p, t in w.items()}
    b1, b2, eps = train["adam_b1"], train["adam_b2"], train["adam_eps"]
    lr, wd = train["learning_rate"], train["weight_decay"]
    losses, grad_norms = [], {}
    for step, (tokens, labels) in enumerate(batches):
        if half_batch:      # half the rows, or of a single row's tokens
            b, s = tokens.shape
            half = (slice(0, b // 2), slice(None)) if b > 1 else \
                (slice(None), slice(0, s // 2))
            tokens, labels = tokens[half], labels[half]
        parts = min(train["microbatches"], tokens.shape[0])
        rows = tokens.shape[0] // parts
        total = 0.0
        for j in range(parts):
            sl = slice(j * rows, (j + 1) * rows)
            loss = _loss(w, tokens[sl], labels[sl], cfg, prec) / parts
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            norm = torch.sqrt(sum(t.grad.square().sum() for t in w.values()))
            clip = torch.clamp(train["grad_clip"] / (norm + 1e-12), max=1.0)
            for path, t in w.items():
                g = t.grad * clip
                t.grad = None
                if step == 0:
                    grad_norms.update(leaf_norms(path, g))
                m[path].mul_(b1).add_((1 - b1) * g)
                v[path].mul_(b2).add_((1 - b2) * g.square())
                del g
                u = (m[path] / (1 - b1 ** (step + 1))) / (
                    torch.sqrt(v[path] / (1 - b2 ** (step + 1))) + eps)
                t.copy_((t - lr * (u + wd * t)).to(stored[path]).float())
    change = {}
    with torch.no_grad():
        for path, t in w.items():
            change.update(leaf_norms(path, t - first[path].float()))
    return {"losses": losses, "grad": grad_norms, "change": change}
