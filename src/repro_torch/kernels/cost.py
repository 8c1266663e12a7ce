"""The work of one launch of each kernel, K1–K7 and the backward of K6
and of K7: the
operations it does,
by the type of the units that do them, and the bytes it must move, each
input read once and each output written once.  ``chip_smoke.py``'s bound
column and the dry-run (``launch/dryrun.py``) both count through these
functions.

Operations count a product's multiply-add as 2 and each element-wise step
as 1; where the work depends on the inputs (causal or windowed attention)
only the (query, key) pairs kept are counted.  Operations are keyed by
the type the product runs in, which sets the peak they are priced at:
``"float32"`` at the CUDA cores' rate, ``"bfloat16"`` at the tensor
cores', ``"tfloat32"`` at the tensor cores' TF32 rate.  K1's, K2's and
K3's products are counted as their kernels run
them: on the tensor cores where ``uses_tc`` says so (K1 and K2 with bf16
w, but K2 at a contraction N <= TC_NARROW; K3 with bf16 x), once where
both operands are bf16 (K1's x in case (a)) and twice where one is fp32
and split into bf16 hi + lo (K1's x in case (b), K2's and K3's dZ
always); on the CUDA cores in fp32.  K6, K7 and their backwards with
bf16 inputs are bf16 products, counted once each (the hi/lo split K7 and
its backward give an fp32 operand is the kernels' way of keeping it
exact, not work the function needs).  K6, K7 and their backwards with
fp32 inputs run every product on the tensor cores as three TF32 products
(3xTF32: an fp32 operand's TF32 hi and lo), so each is counted three
times as ``"tfloat32"``: the route's own work, as K1–K3's hi + lo
products are counted twice.  Element-wise steps
(bias, activation, A'(Y)) and K4/K5 are fp32.  Bytes count each operand
at its element size: K1–K3 take a 4 or 2 for each operand group, an
output in the dtype the kernel gives it.

A kernel wrapper handed meta tensors (the dry-run) returns empty outputs
of the kernel's shapes and reports its launch and ``Cost`` to every
recorder made active by ``recording``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator

__all__ = ["Cost", "recording", "report", "kept_pairs", "TC_NARROW",
           "uses_tc", "fcnn_fwd", "fcnn_dgrad", "fcnn_wgrad", "xent_fwd",
           "xent_dlogits", "flash_attention", "flash_attention_bwd",
           "ssd_chunk", "ssd_chunk_bwd"]


@dataclasses.dataclass(frozen=True)
class Cost:
    """Operations by the operands' type (``"float32"``, ``"bfloat16"`` or
    ``"tfloat32"``) and bytes moved."""

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


# the fp32 products of K6, K7 and their backwards: three TF32 products
# each (3xTF32)
TF32_SPLIT = 3


def _bwd_ops(element_size: int, products: int) -> dict[str, float]:
    """Operations of K6's, K7's or a backward's products as its kernel runs
    them: bf16 once, fp32 as TF32_SPLIT TF32 products."""
    if element_size == 2:
        return {"bfloat16": products}
    return {"tfloat32": TF32_SPLIT * products}


def kept_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal mask over ``s`` tokens keeps, with a
    sliding ``window`` (0: none): q + 1 keys for q < window, then window."""
    if window == 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _ops(product: str, products: int, elementwise: int) -> dict[str, float]:
    """Operations by type: the product's and the fp32 element-wise steps."""
    ops = {product: products}
    ops["float32"] = ops.get("float32", 0) + elementwise
    return ops


# K2's contraction N at or below which the FCNN wrapper
# (kernels/fcnn_layer.py) keeps a bf16-w call on the CUDA cores
TC_NARROW = 16


def uses_tc(kernel: str, *, x_size: int = 4, w_size: int = 4,
            n: int = 0) -> bool:
    """Whether a call of K1-K3 runs on the tensor cores: the one rule the
    wrappers of kernels/fcnn_layer.py dispatch by and the costs below count
    by.  K1 ("fcnn_layer") where w is bf16 (``w_size`` 2); K2
    ("fcnn_layer_dgrad") where w is bf16 and its contraction ``n`` >
    TC_NARROW; K3 ("fcnn_layer_wgrad") where x is bf16 (``x_size`` 2)."""
    if kernel == "fcnn_layer_wgrad":
        return x_size == 2
    if kernel == "fcnn_layer_dgrad":
        return w_size == 2 and n > TC_NARROW
    if kernel == "fcnn_layer":
        return w_size == 2
    raise ValueError(f"no tensor-core rule for {kernel!r}")


def _product(tensor_cores: bool, a_size: int,
             products: int) -> tuple[str, int]:
    """(type, operations) of a K1-K3 product whose other operand has
    ``a_size`` bytes an element, as its kernel runs it: on the tensor
    cores, twice where that operand is fp32 (its bf16 hi and lo); else in
    fp32."""
    if not tensor_cores:
        return "float32", products
    return "bfloat16", products * (1 if a_size == 2 else 2)


def fcnn_fwd(m: int, k: int, n: int, x_size: int = 4,
             w_size: int = 4) -> Cost:
    """K1, act(x @ w + b): x (M, K), w (K, N), b (N,) -> (M, N) in x's
    type; element sizes ``x_size`` of x and the output, ``w_size`` of w
    and b."""
    return Cost(_ops(*_product(uses_tc("fcnn_layer", w_size=w_size), x_size,
                               2 * m * k * n),
                     2 * m * n),
                x_size * (m * k + m * n) + w_size * (k * n + n))


def fcnn_dgrad(m: int, k: int, n: int, dy_size: int = 4,
               w_size: int = 4) -> Cost:
    """K2, (dY ⊙ A'(Y)) Wᵀ: dy, y (M, N), w (K, N) -> (M, K) in dy's type;
    dZ is fp32 whatever the types."""
    tc = uses_tc("fcnn_layer_dgrad", w_size=w_size, n=n)
    return Cost(_ops(*_product(tc, 4, 2 * m * n * k), 2 * m * n),
                dy_size * (2 * m * n + m * k) + w_size * k * n)


def fcnn_wgrad(m: int, k: int, n: int, x_size: int = 4,
               dy_size: int = 4) -> Cost:
    """K3, (Xᵀ dZ, Σ dZ): x (M, K), dy, y (M, N) -> (K, N) in x's type, (N,)
    in dy's; dZ is fp32 whatever the types."""
    return Cost(_ops(*_product(uses_tc("fcnn_layer_wgrad", x_size=x_size), 4,
                               2 * m * k * n), 3 * m * n),
                x_size * (m * k + k * n) + dy_size * (2 * m * n + n))


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
    read once per KV head, QKᵀ and PV over the kept pairs; fp32 as three
    TF32 products each (``_bwd_ops``)."""
    pairs = kept_pairs(s, window) if causal else s * sk
    return Cost(_bwd_ops(element_size, 4 * b * h * pairs * d),
                2 * b * (h * s + kv * sk) * d * element_size)


def flash_attention_bwd(b: int, h: int, kv: int, s: int, sk: int, d: int,
                        element_size: int, causal: bool,
                        window: int = 0) -> Cost:
    """K6's backward: q, o, dO (B, H, S, D), k, v (B, KV, Sk, D) and the
    fp32 lse (B, H, S) -> dq (B, H, S, D), dk, dv (B, KV, Sk, D), and the
    fp32 row correction delta (B, H, S) once; the VJP's five products (S,
    dP, dV, dQ, dK) over the kept pairs, as ``flash_attention`` keeps
    them; fp32 as three TF32 products each (``_bwd_ops``)."""
    pairs = kept_pairs(s, window) if causal else s * sk
    return Cost(_bwd_ops(element_size, 10 * b * h * pairs * d),
                4 * b * (h * s + kv * sk) * d * element_size
                + 2 * b * h * s * 4)


def ssd_chunk(bc: int, q: int, h: int, p: int, n: int, groups: int,
              element_size: int) -> Cost:
    """K7: x (BC, Q, H, P), dt_a (BC, Q, H) fp32, B and C (BC, Q, H, N)
    with ``groups`` distinct heads (1 where they are broadcast, stride 0)
    -> y (BC, Q, H, P), state (BC, H, P, N) fp32, decay (BC, Q, H) fp32.
    Per (chunk, head) S = C·Bᵀ and S∘L·x over the kept pairs and the state
    over the chunk's rows: S is counted once a head, the function's work,
    though a kernel whose block walks the heads of one B/C group forms it
    once a block; fp32 as three TF32 products each (``_bwd_ops``)."""
    pairs = q * (q + 1) // 2
    return Cost(_bwd_ops(element_size,
                         bc * h * (pairs * (2 * n + 2 * p) + 2 * q * p * n)),
                2 * bc * q * h * p * element_size
                + 2 * bc * q * groups * n * element_size
                + bc * h * p * n * 4 + 2 * bc * q * h * 4)


def ssd_chunk_bwd(bc: int, q: int, h: int, p: int, n: int, groups: int,
                  element_size: int) -> Cost:
    """K7's backward: x, dy (BC, Q, H, P), dt_a (BC, Q, H) fp32, B and C
    (BC, Q, H, N) with ``groups`` distinct heads, the fp32 cotangents of
    the state (BC, H, P, N) and the decay (BC, Q, H) -> dx (BC, Q, H, P),
    d(dt_a) (BC, Q, H) fp32, dB and dC (BC, Q, ``groups``, N).  Per (chunk,
    head) the products S = C·Bᵀ, dM = dy·xᵀ, (S∘L)ᵀ·dy, dS·B and dSᵀ·C over
    the kept pairs, and B·dstᵀ and x·dst over the chunk's rows.  This is the
    function's work, what any kernel must do: the bf16 kernel's fp32 parts
    of dB and dC (one a block of heads, added by a second kernel) and its
    sums over a group's heads before dB's and dC's products (which save
    those two products for all but one head of a block) are not counted;
    fp32 as three TF32 products each (``_bwd_ops``)."""
    pairs = q * (q + 1) // 2
    return Cost(_bwd_ops(element_size,
                         bc * h * (pairs * (6 * n + 4 * p) + 4 * q * p * n)),
                3 * bc * q * h * p * element_size
                + 4 * bc * q * groups * n * element_size
                + bc * h * p * n * 4 + 3 * bc * q * h * 4)
