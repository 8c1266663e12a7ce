"""The work of one launch of each kernel, K1–K7: the operations it does,
by the type of the units that do them, and the bytes it must move, each
input read once and each output written once.  ``chip_smoke.py``'s bound
column and the dry-run (``launch/dryrun.py``) both count through these
functions.

Operations count a product's multiply-add as 2 and each element-wise step
as 1; where the work depends on the inputs (causal or windowed attention)
only the (query, key) pairs kept are counted.  ``"float32"`` operations
run on the CUDA cores, ``"bfloat16"`` ones on the tensor cores: K1–K5 do
fp32 arithmetic whatever their inputs, K6 and K7 run on the tensor cores
for bf16 inputs.

A kernel wrapper handed meta tensors (the dry-run) returns empty outputs
of the kernel's shapes and reports its launch and ``Cost`` to every
recorder made active by ``recording``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator

__all__ = ["Cost", "recording", "report", "kept_pairs",
           "fcnn_fwd", "fcnn_dgrad", "fcnn_wgrad", "xent_fwd",
           "xent_dlogits", "flash_attention", "ssd_chunk"]


@dataclasses.dataclass(frozen=True)
class Cost:
    """Operations by the operands' type (``"float32"`` or ``"bfloat16"``)
    and bytes moved."""

    flops: dict[str, float]
    nbytes: float

    def seconds(self, target) -> tuple[float, float]:
        """(operations over ``target``'s peak for their type, bytes over
        its HBM rate): the two floors of the launch's time."""
        compute = sum(f / target.flop_rate(t) for t, f in self.flops.items())
        return compute, self.nbytes / target.hbm_bw


_RECORDERS: list[Any] = []


@contextlib.contextmanager
def recording(recorder: Any) -> Iterator[Any]:
    """Send every meta launch inside the block to ``recorder.kernel(name,
    cost)``."""
    _RECORDERS.append(recorder)
    try:
        yield recorder
    finally:
        _RECORDERS.remove(recorder)


def report(name: str, cost: Cost) -> None:
    """One launch of kernel ``name`` on meta tensors, to every recorder."""
    for r in _RECORDERS:
        r.kernel(name, cost)


def _dtype(element_size: int) -> str:
    return "bfloat16" if element_size == 2 else "float32"


def kept_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal mask over ``s`` tokens keeps, with a
    sliding ``window`` (0: none): q + 1 keys for q < window, then window."""
    if window == 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def fcnn_fwd(m: int, k: int, n: int) -> Cost:
    """K1, act(x @ w + b): x (M, K), w (K, N), b (N,) -> (M, N), fp32."""
    return Cost({"float32": 2 * m * k * n + 2 * m * n},
                4 * (m * k + k * n + n + m * n))


def fcnn_dgrad(m: int, k: int, n: int) -> Cost:
    """K2, (dY ⊙ A'(Y)) Wᵀ: dy, y (M, N), w (K, N) -> (M, K), fp32."""
    return Cost({"float32": 2 * m * n * k + 2 * m * n},
                4 * (2 * m * n + k * n + m * k))


def fcnn_wgrad(m: int, k: int, n: int) -> Cost:
    """K3, (Xᵀ dZ, Σ dZ): x (M, K), dy, y (M, N) -> (K, N), (N,), fp32."""
    return Cost({"float32": 2 * m * k * n + 3 * m * n},
                4 * (m * k + 2 * m * n + k * n + n))


def xent_fwd(b: int, c: int, element_size: int) -> Cost:
    """K4: logits (B, C), labels (B,) -> nll, lse (B,) and their mean."""
    return Cost({"float32": 4 * b * c + b},
                element_size * b * c + 4 * 3 * b + 4)


def xent_dlogits(b: int, c: int, element_size: int,
                 per_row: bool = False) -> Cost:
    """K5: logits (B, C), labels, lse (B,) and the factor (the loss
    cotangent g, or a (B,) scale where ``per_row``) -> dlogits (B, C)."""
    return Cost({"float32": 4 * b * c},
                2 * element_size * b * c + 4 * 2 * b
                + 4 * (b if per_row else 1))


def flash_attention(b: int, h: int, kv: int, s: int, sk: int, d: int,
                    element_size: int, causal: bool,
                    window: int = 0) -> Cost:
    """K6: q (B, H, S, D), k, v (B, KV, Sk, D) -> (B, H, S, D); K and V
    read once per KV head, QKᵀ and PV over the kept pairs."""
    pairs = kept_pairs(s, window) if causal else s * sk
    return Cost({_dtype(element_size): 4 * b * h * pairs * d},
                2 * b * (h * s + kv * sk) * d * element_size)


def ssd_chunk(bc: int, q: int, h: int, p: int, n: int, groups: int,
              element_size: int) -> Cost:
    """K7: x (BC, Q, H, P), dt_a (BC, Q, H) fp32, B and C (BC, Q, H, N)
    with ``groups`` distinct heads (1 where they are broadcast, stride 0)
    -> y (BC, Q, H, P), state (BC, H, P, N) fp32, decay (BC, Q, H) fp32."""
    pairs = q * (q + 1) // 2
    return Cost({_dtype(element_size):
                 bc * h * (pairs * (2 * n + 2 * p) + 2 * q * p * n)},
                2 * bc * q * h * p * element_size
                + 2 * bc * q * groups * n * element_size
                + bc * h * p * n * 4 + 2 * bc * q * h * 4)
