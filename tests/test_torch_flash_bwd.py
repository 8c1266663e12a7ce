"""K6's backward (dQ, dK, dV from the forward's saved log-sum-exp) against
the JAX reference, on the CPU.

The same numpy inputs, made from a seed, go through the reference's
attention VJPs and through the port's plain versions
(``ref.flash_attention_lse_ref``, ``ref.flash_attention_bwd_ref``), which
the wrappers run on CPU tensors:

  * ``jax.vjp`` of ``_sdpa_chunked_causal`` (its flash-style custom VJP,
    ``_sdpa_chunked_bwd``) at a small chunk and at one chunk, with query
    groups of 1, 2 and 4 and D = 16 and 64: fp32 within 1e-5 of each
    gradient's largest element, bf16 within one bf16 ulp + 1e-3 of the
    largest (both round the same fp32 quantities);
  * ``jax.vjp`` of ``_sdpa`` under its masks (causal, causal with a window,
    full with Sq != Sk): fp32 1e-5; bf16 within the bf16 train bar (5e-2
    of the norm).  ``_sdpa`` rounds its probabilities to bf16 before PV, so
    its autodiff rounds the probabilities of dV and the cotangent of those
    probabilities (dP) to bf16 where ``_sdpa_chunked_bwd`` keeps both in
    fp32 and rounds dS instead: the measured size of that difference is
    held in ``test_sdpa_autodiff_rounds_the_probabilities``;
  * the lse against ``_flash_fwd_core``'s;
  * a CPU emulation of the card's bf16 arithmetic (scores and dP in fp32,
    p exponentiated in log2 units, pᵀ as bf16 hi + lo for dV, dS rounded to
    bf16, dQ summed from per-span parts and dK/dV from per-slice parts in
    the unit list's order) within chip_smoke.py's bars of the plain
    version, where p rounded once to bf16 misses dV's (the pattern of
    ``test_ssd_bf16_kernel_arithmetic_meets_the_card_bars``);
  * ``ops.flash_attention``'s autograd function (K6 with its lse, then
    ``flash_attention_bwd``) against ``mode="ref"``'s ordinary autograd;
    the wrappers' checks, their meta path and ``cost.flash_attention_bwd``,
    and the launches a remat'd train step makes (phase 18's count).

The CUDA kernels are held against the same plain versions on the card in
tests/test_torch_kernels_gpu.py and chip_smoke.py's phase 7.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.configs import smoke_config
from repro_torch.core.planner import H100Target
from repro_torch.kernels import cost, ops, ref
from repro_torch.kernels.flash_attention import (BWD_SPAN, BWD_TILE,
                                                 bwd_schedule,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.fcnn_layer import KernelLimitError
from repro_torch.launch.steps import TrainSettings, build_train_step, \
    init_train_state
from repro_torch.models.api import get_model

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)

FP32_RTOL = 1e-5
BF16_ULP = 2.0 ** -7
BF16_SLACK = 1e-3
BF16_TRAIN_NORM = 5e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread beats 8 contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, h, kv, s, sk, d, seed=0):
    """q, dO (B, S, H, D) and k, v (B, Sk, KV, D) in the reference's
    layout, fp32 numpy."""
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, s, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, sk, kv, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _port(a, tdt) -> torch.Tensor:
    """A reference-layout array (B, S, heads, D) as the port's (B, heads,
    S, D) view of the same layout, as the model hands K6 its projections."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(tdt).transpose(1, 2)


def _ref_layout(t: torch.Tensor) -> np.ndarray:
    return t.transpose(1, 2).float().numpy()


def _mask(s, sk, causal, window):
    if not causal:
        return np.ones((s, sk), bool)
    return ref.attention_mask(s, sk, window, "cpu").numpy()


def _close(got, want, dtype) -> float:
    """The worst element of ``got`` as a share of its bar against
    ``want`` (both fp32 numpy): fp32 FP32_RTOL of the largest; bf16 one
    bf16 ulp of |want| + BF16_SLACK of the largest."""
    w = np.asarray(want, np.float64)
    d = np.abs(np.asarray(got, np.float64) - w)
    big = np.abs(w).max()
    if dtype == "float32":
        return d.max() / (FP32_RTOL * big)
    return (d / (BF16_ULP * np.abs(w) + BF16_SLACK * big)).max()


def _norm_err(got, want) -> float:
    w = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - w) / np.linalg.norm(w)


def _port_bwd(q, k, v, do, tdt, causal, window, o=None):
    """(dq, dk, dv) of the port's plain versions in the reference's layout;
    ``o`` (reference layout) replaces the port's own forward output."""
    tq, tk, tv, tdo = (_port(a, tdt) for a in (q, k, v, do))
    out, lse = ref.flash_attention_lse_ref(tq, tk, tv, causal, window)
    if o is not None:
        out = _port(o, tdt)
    return [_ref_layout(g) for g in ref.flash_attention_bwd_ref(
        tq, tk, tv, out, tdo, lse, causal, window)]


# ------------------------------------------------------ the reference VJPs

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("chunk", [32, 128])
def test_plain_bwd_matches_chunked_vjp(dtype, groups, d, chunk):
    """The reference's flash-style VJP at L = 128 (four chunks of 32, or
    one of 128), with its own forward output fed to the port's backward."""
    jdt, tdt = DTYPES[dtype]
    kv, s = 2, 128
    q, k, v, do = _inputs(1, kv * groups, kv, s, s, d, seed=groups + d)
    out, vjp = jax.vjp(lambda a, b, c: JL._sdpa_chunked_causal(a, b, c,
                                                                chunk, 1),
                       *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    got = _port_bwd(q, k, v, do, tdt, True, 0, o=out)
    for name, g, w in zip("qkv", got, want):
        assert _close(g, w, dtype) <= 1, f"d{name}"


SDPA_MASKS = {"causal": (96, 96, True, 0), "window": (96, 96, True, 17),
              "full": (40, 72, False, 0)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("mask", sorted(SDPA_MASKS))
def test_plain_bwd_matches_sdpa_autodiff(dtype, groups, d, mask):
    """``jax.vjp`` of the reference's masked ``_sdpa`` (the path the
    reference's training takes below its chunk threshold): fp32 within
    1e-5 of each gradient's largest; bf16 within the train bar of its
    norm (the rounding difference named in the module docstring)."""
    jdt, tdt = DTYPES[dtype]
    s, sk, causal, window = SDPA_MASKS[mask]
    kv = 2
    q, k, v, do = _inputs(2, kv * groups, kv, s, sk, d, seed=7 * groups + d)
    m = jnp.asarray(_mask(s, sk, causal, window))
    _, vjp = jax.vjp(lambda a, b, c: JL._sdpa(a, b, c, m),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    got = _port_bwd(q, k, v, do, tdt, causal, window)
    for name, g, w in zip("qkv", got, want):
        if dtype == "float32":
            assert _close(g, w, dtype) <= 1, f"d{name}"
        else:
            assert _norm_err(g, w) <= BF16_TRAIN_NORM, f"d{name}"


def test_sdpa_autodiff_rounds_the_probabilities():
    """The named difference, bf16 at (2, 8 on 2, 96, 64) causal: the plain
    backward (``_sdpa_chunked_bwd``'s roundings) against ``_sdpa``'s
    autodiff is a few 1e-3 of each gradient's norm (measured dq 3.5e-3, dk
    3.4e-3, dv 2.4e-3), and ``_sdpa``'s own roundings (bf16 p before PV,
    hence a bf16 dP), which ``mode="ref"``'s autograd of
    ``flash_attention_ref`` repeats, account for it: that twin lands within
    4.0e-5, 1.3e-5 and 4.9e-9 of ``_sdpa``'s autodiff."""
    s, d, kv, h = 96, 64, 2, 8
    q, k, v, do = _inputs(2, h, kv, s, s, d, seed=3)
    m = jnp.asarray(_mask(s, s, True, 0))
    _, vjp = jax.vjp(lambda a, b, c: JL._sdpa(a, b, c, m),
                     *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    got = _port_bwd(q, k, v, do, torch.bfloat16, True, 0)
    leaves = [_port(a, torch.bfloat16).requires_grad_(True)
              for a in (q, k, v)]
    out = ops.flash_attention(*leaves, True, mode="ref")
    twin = torch.autograd.grad(out, leaves, _port(do, torch.bfloat16))
    for name, g, t, w in zip("qkv", got, twin, want):
        plain, same = _norm_err(g, w), _norm_err(_ref_layout(t), w)
        print(f"d{name}: chunked roundings {plain:.2e}, _sdpa's own "
              f"{same:.2e} of the norm")
        assert 5e-4 < plain <= 1e-2, f"d{name}"
        assert same < plain / 10, f"d{name}"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("groups", [1, 4])
def test_lse_matches_flash_fwd_core(dtype, groups):
    jdt, tdt = DTYPES[dtype]
    b, kv, s, d, chunk = 2, 2, 128, 32, 32
    q, k, v, _ = _inputs(b, kv * groups, kv, s, s, d, seed=groups)
    qg = jnp.asarray(q, jdt).reshape(b, s, kv, groups, d)
    kc, vc = (jnp.asarray(a, jdt).reshape(b, s // chunk, chunk, kv, d)
              for a in (k, v))
    _, want = JL._flash_fwd_core(qg, kc, vc, chunk, 1)     # (B, KV, G, L)
    o, got = ref.flash_attention_lse_ref(*(_port(a, tdt) for a in (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (b, kv * groups, s)
    np.testing.assert_allclose(got.reshape(b, kv, groups, s).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(o, ref.flash_attention_ref(
        *(_port(a, tdt) for a in (q, k, v))), rtol=0, atol=0)


# --------------------------------------------- the card's bf16 arithmetic

def emulate_bwd(q, k, v, o, do, lse, causal, window, split=True):
    """The bf16 kernel's arithmetic (flash_attention_bwd.cu) in torch:
    scores and dP as fp32 sums of bf16 products, p = exp2(s·log2(e)/√D −
    lse·log2(e)), delta = Σ o·dO; pᵀ enters dV's product as bf16 hi + lo
    (``split``) or rounded once to bf16; dS rounded to bf16 for dQ and dK;
    and the kernel's order of summation from its unit list
    (``bwd_schedule``): each dQ tile the fp32 sum of one part a 128-key
    span (its two warpgroups' 64-key parts added first), part r added in
    rank order into slot r % slots, the slots then added in slot order;
    each span's dK and dV the fp32 sum of one part a walk slice, added in
    list order; the gradients rounded once to bf16."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    log2e = 1.4426950408889634
    qf = q.float().reshape(b, kv, g, sq, d)
    dof = do.float().reshape(b, kv, g, sq, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bkmd->bkgqm", qf, kf)
    p = torch.exp2(s * (log2e / math.sqrt(d))
                   - lse.reshape(b, kv, g, sq, 1) * log2e)
    if causal:
        p = torch.where(ref.attention_mask(sq, sk, window, "cpu"), p, 0.0)
    delta = (o.float() * do.float()).sum(-1).reshape(b, kv, g, sq, 1)
    dp = torch.einsum("bkgqd,bkmd->bkgqm", dof, vf)
    ds = (p * (dp - delta) * (1.0 / math.sqrt(d))).bfloat16().float()
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    sched = bwd_schedule(b, h, kv, sq, sk, d, bool(causal), window)
    tile, span = BWD_TILE, BWD_SPAN
    dq = torch.zeros(b, kv, g, sq, d)
    for qt, ranks in enumerate(sched.dq_rank):
        rows = slice(tile * qt, tile * qt + tile)
        slots = [None] * sched.slots
        for r, n in enumerate(sorted((n for n, r in enumerate(ranks)
                                      if r >= 0), key=ranks.__getitem__)):
            part = [torch.einsum("bkgqm,bkmd->bkgqd", ds[..., rows, keys],
                                 kf[..., keys, :])
                    for keys in (slice(span * n + half, span * n + half + 64)
                                 for half in (0, 64))]
            part = part[0] + part[1]
            x = r % sched.slots
            slots[x] = part if slots[x] is None else slots[x] + part
        for x in slots:
            if x is not None:
                dq[..., rows, :] += x
    dk, dv = torch.zeros(b, kv, sk, d), torch.zeros(b, kv, sk, d)
    for n, qt_lo, qt_hi, _, _ in sched.units:     # list order
        rows = slice(tile * qt_lo, tile * qt_hi)
        keys = slice(span * n, span * n + span)
        dk[..., keys, :] += torch.einsum("bkgqm,bkgqd->bkmd",
                                         ds[..., rows, keys], qf[..., rows, :])
        part = torch.einsum("bkgqm,bkgqd->bkmd", (hi if split else p.bfloat16(
        ).float())[..., rows, keys], dof[..., rows, :])
        if split:
            part = part + torch.einsum("bkgqm,bkgqd->bkmd",
                                       lo[..., rows, keys], dof[..., rows, :])
        dv[..., keys, :] += part
    return (dq.reshape(b, h, sq, d).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


EMULATED = {"causal": (1, 8, 2, 512, 64, 512, True, 0),
            "window": (1, 4, 2, 512, 64, 512, True, 100),
            "cross": (1, 4, 4, 128, 64, 300, False, 0)}


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_bf16_kernel_arithmetic_meets_the_card_bars(case):
    """The emulated kernel within chip_smoke.py's phase-7 bars of the plain
    version (``k6_bwd_close`` for dQ, dK, dV; ``rounded_once`` for dV);
    with p rounded once to bf16 for dV, dV misses ``rounded_once``."""
    b, h, kv, s, d, sk, causal, window = EMULATED[case]
    q, k, v, do = (_port(a, torch.bfloat16)
                   for a in _inputs(b, h, kv, s, sk, d, seed=5))
    o, lse = ref.flash_attention_lse_ref(q, k, v, causal, window)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal, window)
    got = emulate_bwd(q, k, v, o, do, lse, causal, window)
    for name, g, w, noise in zip("qkv", got, want,
                                 SMOKE.k6_bwd_noise(q, k, v, do)):
        ok, _, crit = SMOKE.k6_bwd_close(torch, g, w, noise)
        print(f"d{name}: {crit}")
        assert ok, f"d{name}: {crit}"
    ok, note = SMOKE.rounded_once(torch, got[2], want[2])
    print(f"dv hi + lo: {note}")
    assert ok, note
    once = emulate_bwd(q, k, v, o, do, lse, causal, window, split=False)
    ok, note = SMOKE.rounded_once(torch, once[2], want[2])
    print(f"dv p rounded once: {note}")
    assert not ok, note


# ------------------------------------------------------- the autograd op

AUTOGRAD_CASES = {"causal gqa": (2, 4, 2, 37, 37, 16, True, 0),
                  "window": (1, 4, 1, 50, 50, 64, True, 7),
                  "cross": (1, 4, 4, 20, 33, 16, False, 0)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(AUTOGRAD_CASES))
def test_autograd_function_matches_ref_mode(dtype, case, monkeypatch):
    """``ops.flash_attention`` on inputs that require grad: K6 with its lse
    forward (the output equal to ``mode="ref"``'s), one
    ``flash_attention_bwd`` call backward, gradients within 1e-5 of
    ``mode="ref"``'s autograd in fp32 and the train bar in bf16 (whose
    autograd rounds like ``_sdpa``); no launch on the CPU."""
    _, tdt = DTYPES[dtype]
    b, h, kv, s, sk, d, causal, window = AUTOGRAD_CASES[case]
    q, k, v, do = _inputs(b, h, kv, s, sk, d, seed=11)
    calls = []
    real = ops._flash_attention_bwd
    monkeypatch.setattr(ops, "_flash_attention_bwd",
                        lambda *a: calls.append(a) or real(*a))
    before = ops.launch_counts()
    grads, outs = {}, {}
    for mode in (None, "ref"):
        leaves = [_port(a, tdt).requires_grad_(True) for a in (q, k, v)]
        out = ops.flash_attention(*leaves, causal, window=window, mode=mode)
        outs[mode] = out.detach()
        grads[mode] = torch.autograd.grad(out, leaves, _port(do, tdt))
    assert len(calls) == 1 and ops.launch_counts() == before
    assert torch.equal(outs[None], outs["ref"])
    for name, g, w in zip("qkv", grads[None], grads["ref"]):
        assert g.dtype == tdt and g.shape == w.shape
        if dtype == "float32":
            assert _close(g.numpy(), w.numpy(), dtype) <= 1, f"d{name}"
        else:
            assert _norm_err(g.float().numpy(), w.float().numpy()) \
                <= BF16_TRAIN_NORM, f"d{name}"


def test_no_grad_attention_skips_the_lse(monkeypatch):
    """Serving (no input requires grad) calls K6 without its lse, as
    before; the raw wrappers keep refusing inputs that require grad."""
    seen = []
    real = ops._flash_attention
    monkeypatch.setattr(ops, "_flash_attention",
                        lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    q = torch.randn(1, 2, 8, 16)
    ops.flash_attention(q, q, q)
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(True), q, q)
    assert seen == [{}, {}]
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q, q, q, lse=True)


def test_unit_rows_copies_only_what_the_kernel_cannot_read():
    t = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    view = torch.zeros(1, 4, 8, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert ops._unit_rows(t) is t and ops._unit_rows(view) is view
    ones = torch.ones((), dtype=torch.bfloat16).expand(1, 8, 4, 64)
    out = ops._unit_rows(ones)
    assert out.is_contiguous() and torch.equal(out, ones)
    odd = torch.zeros(1, 2, 8, 33, dtype=torch.bfloat16)[..., :32]
    assert ops._unit_rows(odd).is_contiguous()


# ------------------------------------------------ wrapper, meta, cost

def test_bwd_wrapper_checks():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    lse = torch.zeros(1, 4, 8)
    assert [g.shape for g in flash_attention_bwd(q, k, k, q, q, lse)] == \
        [q.shape, k.shape, k.shape]
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_bwd(q, k, k, q, q, lse[..., :4])
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_bwd(q, k, k, q, q, lse.bfloat16())
    with pytest.raises(ValueError, match="must have q's shape"):
        flash_attention_bwd(q, k, k, q[:, :, :4], q, lse)
    with pytest.raises(ValueError, match="causal attention needs Sq == Sk"):
        flash_attention_bwd(q, k[:, :, :4], k[:, :, :4], q, q, lse)
    with pytest.raises(KernelLimitError, match="D <= 128"):
        big = torch.zeros(1, 1, 4, 130)
        flash_attention_bwd(big, big, big, big, big, torch.zeros(1, 1, 4))
    with pytest.raises(TypeError, match="mixed dtypes"):
        flash_attention_bwd(q, k, k, q, q.bfloat16(), lse)
    odd = torch.zeros(1, 4, 8, 33, dtype=torch.bfloat16)[..., :16]
    qb, kb = q.bfloat16(), k.bfloat16()
    with pytest.raises(ValueError, match="TMA"):
        flash_attention_bwd(qb, kb, kb, qb, odd, lse)
    before = ops.launch_counts()
    flash_attention_bwd(qb, kb, kb, qb, qb, lse, window=3)
    assert ops.launch_counts() == before


class _Recorder:
    def __init__(self):
        self.calls = []

    def kernel(self, name, c):
        self.calls.append((name, c))


def test_meta_path_reports_both_kernels():
    """One launch of K6 and one of its backward on meta, in bf16 and fp32,
    each with its cost (fp32's backward priced as 3xTF32 products)."""
    for dtype in (torch.bfloat16, torch.float32):
        meta = dict(device="meta", dtype=dtype)
        q = torch.empty(2, 8, 300, 64, **meta).transpose(1, 2).contiguous() \
            .transpose(1, 2)
        k = torch.empty(2, 2, 300, 64, **meta)
        leaves = [t.requires_grad_(True) for t in (q, k, k.clone())]
        with cost.recording(_Recorder()) as rec:
            out = ops.flash_attention(*leaves, True, window=50)
            dq, dk, dv = torch.autograd.grad(out, leaves,
                                             torch.empty_like(out))
        assert [n for n, _ in rec.calls] == ["flash_attention",
                                             "flash_attention_bwd"]
        want = cost.flash_attention_bwd(2, 8, 2, 300, 300, 64,
                                        q.element_size(), True, 50)
        assert rec.calls[1][1] == want
        assert set(want.flops) == {"bfloat16" if dtype == torch.bfloat16
                                   else "tfloat32"}
        assert dq.is_meta and dq.shape == q.shape and \
            dq.stride() == q.stride()
        assert dk.shape == dv.shape == k.shape and ops.launch_counts()[
            "flash_attention_bwd"] == 0


def test_bwd_cost_and_bound_at_granite():
    """Five products over the kept pairs (10·B·H·pairs·D), 2.5x the
    forward's operations; bytes: q, o, dO, dq at H heads, k, v, dk, dv at
    KV heads, lse and delta; bound by the bf16 operations at granite-3-2b's
    (1, 32, 2048, 64) on 8 KV heads: 0.04345 ms.  In fp32 the products run
    as three TF32 products each (3xTF32), priced at the TF32 peak: 0.26043
    ms, where the same products on the CUDA cores would take 0.64135."""
    c = cost.flash_attention_bwd(1, 32, 8, 2048, 2048, 64, 2, True)
    f = cost.flash_attention(1, 32, 8, 2048, 2048, 64, 2, True)
    pairs = cost.kept_pairs(2048, 0)
    assert c.flops == {"bfloat16": 10 * 32 * pairs * 64}
    assert c.flops["bfloat16"] == 2.5 * f.flops["bfloat16"]
    assert c.nbytes == 4 * (32 + 8) * 2048 * 64 * 2 + 2 * 32 * 2048 * 4
    ops_s, bytes_s = c.seconds(H100Target())
    assert ops_s > bytes_s and round(ops_s * 1e3, 5) == 0.04345
    f32 = cost.flash_attention_bwd(1, 32, 8, 2048, 2048, 64, 4, True)
    assert f32.flops == {"tfloat32": 3 * c.flops["bfloat16"]}
    ops_s, bytes_s = f32.seconds(H100Target())
    assert ops_s > bytes_s and round(ops_s * 1e3, 5) == 0.26043
    assert round(c.flops["bfloat16"] / H100Target().flop_rate("float32")
                 * 1e3, 5) == 0.64135
    w = cost.flash_attention_bwd(1, 32, 32, 4096, 4096, 64, 4, True, 1000)
    assert w.flops["tfloat32"] == 3 * 10 * 32 * cost.kept_pairs(4096, 1000) \
        * 64
    x = cost.flash_attention_bwd(1, 16, 16, 512, 1024, 64, 2, False)
    assert x.flops["bfloat16"] == 10 * 16 * 512 * 1024 * 64


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_train_step_launches_match_phase_18(family, monkeypatch):
    """A remat'd smoke train step calls K6 twice a layer and microbatch
    (the recompute) and its backward once, Zamba2's unremat'd shared block
    once each, as ``chip_smoke.train_launches`` (phase 18's expectation)
    counts them; the CPU step launches nothing."""
    arch = {"dense": "granite-3-2b", "hybrid": "zamba2-1.2b"}[family]
    cfg = smoke_config(arch).replace(remat=True)
    model = get_model(cfg)
    calls = dict.fromkeys(("flash_attention", "flash_attention_bwd"), 0)
    for attr, name in (("_flash_attention", "flash_attention"),
                       ("_flash_attention_bwd", "flash_attention_bwd")):
        real = getattr(ops, attr)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, attr, spy)
    settings = TrainSettings(microbatches=2)
    state = init_train_state(model, settings, torch.Generator().manual_seed(0),
                             "cpu")
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 17),
                                        dtype=np.int32))
    before = ops.launch_counts()
    build_train_step(model, settings)(state, {"tokens": tok[:, :-1],
                                              "labels": tok[:, 1:]})
    want = SMOKE.train_launches(cfg, 2, True)
    assert calls == {k: want[k] for k in calls} and all(calls.values())
    assert ops.launch_counts() == before


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("family", ["dense", "hybrid", "moe"])
def test_chunked_vjp_rounding_moves_a_smoke_step(family, dtype):
    """The backward's named difference from ``_sdpa``'s autodiff at the
    scale of a train step, plain against plain: on the CPU the fused path
    (``ops._FlashAttention``: ``flash_attention_bwd_ref``, dS rounded as
    ``_sdpa_chunked_bwd`` rounds it) and ``mode="ref"`` (autograd of
    ``flash_attention_ref``) share the forward, so step 1's losses are
    equal, and in bf16 the gradient norms part by more than 1e-5 (1.9e-5
    dense, 4.7e-4 hybrid, 2.5e-4 moe) but within phase 18's 1e-2, each
    leaf within its 5e-2; in fp32, where neither path rounds, within
    1e-5.  The card's step test holds its kernel path to the plain path
    at the bars this sets (tests/test_torch_lm_train.py)."""
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.parallel import gradsync

    arch = {"dense": "granite-3-2b", "hybrid": "zamba2-1.2b",
            "moe": "qwen2-moe-a2.7b"}[family]
    cfg = smoke_config(arch).replace(dtype=dtype, param_dtype=dtype,
                                     remat=True)
    model = get_model(cfg)
    params = init_train_state(model, TrainSettings(microbatches=2),
                              torch.Generator().manual_seed(0),
                              "cpu")["params"]
    rng = np.random.default_rng(13)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 33),
                                        dtype=np.int32))
    micro = {"tokens": tok[:, :-1].reshape(2, 1, 32),
             "labels": tok[:, 1:].reshape(2, 1, 32)}
    out = {}
    for mode in (None, "ref"):
        loss, grads = gradsync.accumulate_grads(
            lambda p, b, m=mode: model.loss_fn(p, b, mode=m), params, micro)
        out[mode] = (loss.item(), global_norm(grads).item(),
                     dict(SMOKE._paths(grads)))
    assert out[None][0] == out["ref"][0]
    gap = abs(out[None][1] - out["ref"][1]) / out["ref"][1]
    leaves = max(((a.float() - b.float()).norm()
                  / b.float().norm().clamp_min(1e-30)).item()
                 for a, b in ((out[None][2][p], g)
                              for p, g in out["ref"][2].items()))
    if dtype == "float32":
        assert gap <= 1e-5 and leaves <= 1e-4, (gap, leaves)
    else:
        assert 1e-5 < gap <= SMOKE.TRAIN_GNORM_RTOL, gap
        assert leaves <= SMOKE.TRAIN_LEAF_RTOL, leaves
