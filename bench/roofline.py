"""The yardstick's arithmetic: the H100's published peaks, the work of a
training step in model FLOPs, and the operations and bytes of one launch of
the kernels the per-layer rooflines read.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (989 TFLOP/s bf16, 495
TF32, 67 fp32 outside the tensor cores, 3.35 TB/s HBM3).  They assume the
card's full 700 W; a run prints the card's power limit beside them.

``flash_attention``, ``flash_attention_bwd``, ``xent_fwd`` and
``xent_dlogits`` are copies of the program's ``kernels/cost.py``: a
product's multiply-add counts 2, each input byte is read once and each
output byte written once, causal attention counts the (query, key) pairs it
keeps, and products of bf16 operands are priced at the bf16 peak, of fp32
operands at three TF32 products (the program's 3xTF32 route).  K4 and K5
are fp32 element-wise work.

``param_count`` and ``active_param_count`` copy the program's
``launch/dryrun.py`` arithmetic; ``train_step_flops`` is 6 x active
parameters x tokens (its ``model_flops``) plus the causal attention products
it leaves out, the forward's two and the backward's four, each over the
kept pairs, with no recompute counted.
"""

from __future__ import annotations

__all__ = ["PEAK", "HBM_BW", "Cost", "kept_pairs", "flash_attention",
           "flash_attention_bwd", "xent_fwd", "xent_dlogits", "param_count",
           "active_param_count", "train_step_flops"]

PEAK = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
HBM_BW = 3.35e12
TF32_SPLIT = 3


class Cost:
    """Operations by the type they are priced at, and bytes moved."""

    def __init__(self, flops: dict[str, float], nbytes: float):
        self.flops, self.nbytes = flops, nbytes

    def bound_s(self) -> float:
        """The least time the card could take: the larger of operations
        over their peak and bytes over the HBM rate."""
        compute = sum(f / PEAK[t] for t, f in self.flops.items())
        return max(compute, self.nbytes / HBM_BW)


def _ops(element_size: int, products: float) -> dict[str, float]:
    if element_size == 2:
        return {"bfloat16": products}
    return {"tfloat32": TF32_SPLIT * products}


def kept_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs a causal mask over ``s`` tokens keeps."""
    if window == 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_attention(b: int, h: int, kv: int, s: int, sk: int, d: int,
                    element_size: int, causal: bool, window: int = 0) -> Cost:
    """K6: q (B, H, S, D), k, v (B, KV, Sk, D) -> o (B, H, S, D)."""
    pairs = kept_pairs(s, window) if causal else s * sk
    return Cost(_ops(element_size, 4 * b * h * pairs * d),
                2 * b * (h * s + kv * sk) * d * element_size)


def flash_attention_bwd(b: int, h: int, kv: int, s: int, sk: int, d: int,
                        element_size: int, causal: bool,
                        window: int = 0) -> Cost:
    """K6's backward: q, o, dO, k, v and the fp32 lse -> dq, dk, dv and the
    fp32 delta; five products (S, dP, dV, dQ, dK) over the kept pairs."""
    pairs = kept_pairs(s, window) if causal else s * sk
    return Cost(_ops(element_size, 10 * b * h * pairs * d),
                4 * b * (h * s + kv * sk) * d * element_size
                + 2 * b * h * s * 4)


def xent_fwd(b: int, c: int, element_size: int) -> Cost:
    """K4: logits (B, C), labels (B,) -> nll, lse (B,) and their mean."""
    return Cost({"float32": 4 * b * c + b},
                element_size * b * c + 4 * 3 * b + 4)


def xent_dlogits(b: int, c: int, element_size: int,
                 per_row: bool = False) -> Cost:
    """K5: logits (B, C), labels, lse (B,) and the loss cotangent ->
    dlogits (B, C)."""
    return Cost({"float32": 4 * b * c},
                2 * element_size * b * c + 4 * 2 * b
                + 4 * (b if per_row else 1))


def param_count(cfg: dict) -> float:
    """Parameters of a dense or MoE configuration file (embeddings counted
    once where tied; norms not counted)."""
    d, n_l, v = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    emb = v * d * (1 if cfg["tie_word_embeddings"] else 2)
    h, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    attn = d * hd * (h + 2 * kv) + h * hd * d
    e = cfg.get("num_local_experts", 0)
    if e:
        ffn = e * 3 * d * cfg["intermediate_size"] + d * e
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return emb + n_l * (attn + ffn)


def active_param_count(cfg: dict) -> float:
    """Parameters a token passes through (MoE: k of E experts)."""
    total = param_count(cfg)
    e = cfg.get("num_local_experts", 0)
    if not e:
        return total
    per_expert = cfg["num_hidden_layers"] * 3 * cfg["hidden_size"] * cfg[
        "intermediate_size"]
    return total - (e - cfg["num_experts_per_tok"]) * per_expert


def train_step_flops(cfg: dict, traffic: dict) -> float:
    """Model FLOPs of one training step of ``traffic``'s batch."""
    b, s = traffic["batch"], traffic["seq"]
    dense = 6.0 * active_param_count(cfg) * b * s
    attn = (12.0 * cfg["num_hidden_layers"] * b * cfg["num_attention_heads"]
            * cfg["head_dim"] * kept_pairs(s))
    return dense + attn
