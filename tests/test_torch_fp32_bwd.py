"""The fp32 backwards of K6 and K7 on the tensor cores (3xTF32), on the CPU.

Both kernels (``csrc/flash_attention_bwd.cu`` ``flash_bwd_tf32_kernel``,
``csrc/ssd_scan_bwd.cu`` ``ssd_bwd_tf32_kernel``) take every product of
fp32 operands as three TF32 products on ``mma.sync``: each operand x split
into hi = tf32(x) (rounded to nearest, 10 stored mantissa bits) and lo =
x − hi truncated to 10, a·b as lo_a·hi_b + hi_a·lo_b + hi_a·hi_b into an fp32
accumulator, eight terms of the contraction a step.  Their arithmetic is
emulated here in torch, in their order of sums:

  * K6: the unit list ``bwd_schedule`` builds with 64-key spans; a pair's
    Sᵀ and dPᵀ once, dV and dK summed over a walk in two halves of 32
    queries (added half 0 + half 1 at the walk's end, then into the span's
    sum in list order), dQ's part of each (tile, span) added into slot
    rank % slots in rank order, the slots added in slot order;
  * K7: a block of ``ssd_bwd_plan``'s heads of one B/C group; Sᵀ once a
    block; each head's dx = w∘(B·dstᵀ) and then Wᵀ·dy, ΣdSᵀ summed in head
    order, Σ w∘F in head order; dB = ΣdSᵀ·C onto it and dC = ΣdS·B once a
    block; the blocks' parts added in block order.

The same numpy inputs, made from a seed, go through the emulations and
the JAX reference's VJPs (``_sdpa_chunked_causal``'s flash-style VJP
``_sdpa_chunked_bwd`` and ``jax.vjp`` of ``_sdpa`` under a mask for K6;
``jax.vjp`` of ``repro/kernels/ref.py``'s ``ssd_chunk_ref`` for K7), held
at chip_smoke.py phase 7's fp32 bars (``k6_bwd_close``, ``k7_bwd_close``).
Phase 7's float64 witness is held here too: the emulated kernel's
distance to the plain version run in float64 is within ``F64_WITNESS``
(8x) of the fp32 plain version's, where one TF32 product a term lands far
past it.  Then the host plans of the fp32 kernels: the 64-key unit list,
the heads a block and each kernel's shared memory against the H100's
232,448 bytes a block.  The CUDA kernels themselves are held to the plain
versions on the card (tests/test_torch_kernels_gpu.py, chip_smoke.py
phase 7).
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (BWD_F32_SPAN, BWD_TILE,
                                                 bwd_schedule)
from repro_torch.kernels.ssd_scan import SSD_BWD_HEADS, ssd_bwd_plan

import test_torch_kernels_gpu as GPU

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)

SMEM_PER_BLOCK = 232_448    # the H100's opt-in shared memory a block
SMEM_PER_SM = 233_472


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread beats 8 contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ 3xTF32 products

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` as ``tc::to_tf32`` takes it: fp32 rounded to 10
    stored mantissa bits, to nearest with ties away from zero (half an ulp
    added to the bits, the low 13 cleared)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32) \
        .view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 with its 13 low bits cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``tc::split_tf32``: hi = tf32(x), lo = x − hi truncated to tf32."""
    hi = tf32(x)
    return hi, truncate(x - hi)


def mma(a: torch.Tensor, b: torch.Tensor, acc=None,
        passes: int = 3) -> torch.Tensor:
    """``acc`` + a (..., m, k) @ b (..., k, n) as the kernels take it: eight
    terms of k a step; ``passes`` 3: lo_a·hi_b, hi_a·lo_b, then hi_a·hi_b
    into the fp32 accumulator (``tc::mma_3xtf32``); 1: hi_a·hi_b alone
    (one TF32 product a term)."""
    (ah, al), (bh, bl) = split(a), split(b)
    d = torch.zeros(*a.shape[:-1], b.shape[-1]) if acc is None else acc
    for k0 in range(0, a.shape[-1], 8):
        k = slice(k0, k0 + 8)
        if passes == 3:
            d = d + al[..., k] @ bh[..., k, :]
            d = d + ah[..., k] @ bl[..., k, :]
        d = d + ah[..., k] @ bh[..., k, :]
    return d


def test_tf32_split_keeps_22_bits():
    """One TF32 rounding is within 2^-11 of x relative, hi + lo within
    2^-22 (lo truncated: v − hi has at most 13 significant bits, of which
    it drops 2); both leave the low 13 bits zero, and tf32 rounds to
    nearest with ties away from zero."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32)) * 1e3
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    one = ((hi.double() - x.double()).abs() / x.double().abs()).max().item()
    two = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert 2 ** -13 < one <= 2 ** -11 and two <= 2 ** -22
    assert tf32(torch.tensor([1 + 2 ** -11])).item() == 1 + 2 ** -10
    assert tf32(torch.tensor([-(1 + 2 ** -11)])).item() == -(1 + 2 ** -10)


@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000,
                                  0x7F800001])
def test_tf32_split_keeps_nan(bits):
    """A NaN of any payload and sign stays NaN through the split (in hi,
    or in lo where the carry zeroes hi: 0x7FFFFFFF's hi is −0.0 and
    0xFFFFFFFF's +0.0) and through the 3xTF32 product, and spoils only its
    own row; an inf operand leaves its row non-finite."""
    nan = torch.tensor([bits - 2 ** 32 if bits >= 2 ** 31 else bits],
                       dtype=torch.int64).to(torch.int32).view(torch.float32)
    hi, lo = split(nan)
    assert hi.isnan().any() or lo.isnan().any()
    a = torch.ones(16, 8)
    a[3, 5] = nan.item()
    d = mma(a, torch.ones(8, 8))
    assert d[3].isnan().all() and d[[0, 1, 2, 4]].isfinite().all()
    for inf in (math.inf, -math.inf):
        assert tf32(torch.tensor([inf])).item() == inf
        a[3, 5] = inf
        d = mma(a, torch.ones(8, 8))
        assert not d[3].isfinite().any() and d[[0, 1, 2, 4]].isfinite().all()


# --------------------------------------------------------- K6 backward

def emulate_k6(q, k, v, o, do, lse, causal, window, passes=3):
    """``flash_bwd_tf32_kernel``'s arithmetic (module docstring) on fp32
    (B, H, S, D) q, o, do and (B, KV, Sk, D) k, v, lse (B, H, S)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    qg, dog = (t.reshape(b, kv, g, sq, d) for t in (q, do))
    lg = lse.reshape(b, kv, g, sq)
    delta = (o * do).sum(-1).reshape(b, kv, g, sq)
    keep = (ref.attention_mask(sq, sk, window, "cpu") if causal
            else torch.ones(sq, sk, dtype=torch.bool))
    sched = bwd_schedule(b, h, kv, sq, sk, d, bool(causal), window,
                         BWD_F32_SPAN)
    span = sched.span
    slots = [None] * sched.slots
    dk, dv = torch.zeros(b, kv, sk, d), torch.zeros(b, kv, sk, d)
    for n, lo, hi, rank, _ in sched.units:          # list order
        keys = slice(span * n, min(span * n + span, sk))
        kt, vt = k[:, :, keys], v[:, :, keys]
        dka = [torch.zeros_like(kt), torch.zeros_like(kt)]
        dva = [torch.zeros_like(vt), torch.zeros_like(vt)]
        for qt in range(hi - 1, lo - 1, -1):
            rows = slice(BWD_TILE * qt, min(BWD_TILE * qt + BWD_TILE, sq))
            for gg in range(g):
                qs, os_ = qg[:, :, gg, rows], dog[:, :, gg, rows]
                st = mma(kt, qs.transpose(-1, -2), passes=passes)
                dpt = mma(vt, os_.transpose(-1, -2), passes=passes)
                p = torch.exp(st * scale - lg[:, :, gg, None, rows])
                p = torch.where(keep[rows, keys].T, p, 0.0)
                ds = p * (dpt - delta[:, :, gg, None, rows]) * scale
                for half in (0, 1):
                    c = slice(32 * half, 32 * half + 32)
                    dva[half] = mma(p[..., c], os_[..., c, :], dva[half],
                                    passes)
                    dka[half] = mma(ds[..., c], qs[..., c, :], dka[half],
                                    passes)
                part = mma(ds.transpose(-1, -2), kt, passes=passes)
                r = sched.dq_rank[qt][n]
                x = r % sched.slots
                if slots[x] is None:
                    slots[x] = torch.zeros(b, kv, g, sq, d)
                if r < sched.slots:
                    slots[x][:, :, gg, rows] = part
                else:
                    slots[x][:, :, gg, rows] += part
        for out, a in ((dk, dka), (dv, dva)):
            pk = a[0] + a[1]
            out[:, :, keys] = pk if rank == 0 else out[:, :, keys] + pk
    dq = slots[0]
    for x in slots[1:]:
        if x is not None:
            dq = dq + x
    return dq.reshape(b, h, sq, d), dk, dv


def _k6_inputs(b, h, kv, s, sk, d, causal, window, seed):
    """q, k, v, dO fp32 numpy in the reference's (B, S, heads, D) layout,
    and the port's views with the plain version's o and lse."""
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, s, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, sk, kv, d)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv, tdo = (torch.from_numpy(a).transpose(1, 2)
                       for a in (q, k, v, do))
    o, lse = ref.flash_attention_lse_ref(tq, tk, tv, causal, window)
    return (q, k, v, do), (tq, tk, tv, o, tdo, lse)


# (B, H, KV, S, D, Sk, causal, window): causal GQA over ragged spans and
# tiles, D = 64 and 128, a window, cross-attention with Sq != Sk
K6_CASES = {"causal gqa": (1, 4, 2, 200, 64, 200, True, 0),
            "causal d128": (1, 2, 1, 130, 128, 130, True, 0),
            "window": (1, 4, 4, 160, 32, 160, True, 37),
            "cross": (2, 2, 2, 70, 16, 150, False, 0)}


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_fp32_kernel_arithmetic_meets_the_card_bars(case):
    """The emulated kernel against the reference's VJPs (fp32): causal
    against ``_sdpa_chunked_causal``'s flash-style VJP at one chunk, the
    window and cross-attention against ``jax.vjp`` of ``_sdpa`` under the
    mask, each gradient within phase 7's ``k6_bwd_close`` (1e-4 of its
    largest + the fp32 noise floor)."""
    b, h, kv, s, d, sk, causal, window = K6_CASES[case]
    ref_in, port = _k6_inputs(b, h, kv, s, sk, d, causal, window, seed=21)
    jq, jk, jv = (jnp.asarray(a) for a in ref_in[:3])
    if causal and not window:
        _, vjp = jax.vjp(lambda a, b_, c: JL._sdpa_chunked_causal(
            a, b_, c, s, 1), jq, jk, jv)
    else:
        m = jnp.asarray(ref.attention_mask(s, sk, window, "cpu").numpy()
                        if causal else np.ones((s, sk), bool))
        _, vjp = jax.vjp(lambda a, b_, c: JL._sdpa(a, b_, c, m), jq, jk, jv)
    want = [torch.from_numpy(np.asarray(w, np.float32)).transpose(1, 2)
            for w in vjp(jnp.asarray(ref_in[3]))]
    got = emulate_k6(*port, causal, window)
    tq, tk, tv, _, tdo, _ = port
    for name, g_, w, noise in zip("qkv", got, want,
                                  SMOKE.k6_bwd_noise(tq, tk, tv, tdo)):
        ok, _, crit = SMOKE.k6_bwd_close(torch, g_.contiguous(),
                                         w.contiguous(), noise)
        print(f"d{name}: {crit}")
        assert ok, f"d{name}: {crit}"


@pytest.mark.parametrize("passes", [3, 1])
def test_k6_fp32_float64_witness(passes):
    """Phase 7's witness: at (1, 4 on 2, 256, 64) causal the emulated
    kernel's distance to the plain version in float64 is within 8x the
    fp32 plain version's for every gradient (``chip_smoke.f64_witness``);
    with one TF32 product a term it is not."""
    shape = (1, 4, 2, 256, 64, 256, True, 0)
    b, h, kv, s, d, sk, causal, window = shape
    _, port = _k6_inputs(b, h, kv, s, sk, d, causal, window, seed=23)
    want = ref.flash_attention_bwd_ref(*port, causal, window)
    want64 = ref.flash_attention_bwd_ref(*(t.double() for t in port),
                                         causal, window)
    got = emulate_k6(*port, causal, window, passes)
    ok, note = SMOKE.f64_witness(("dq", "dk", "dv"), got, want, want64)
    print(note)
    assert ok == (passes == 3), note


@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF])
def test_k6_fp32_kernel_arithmetic_keeps_nan(bits):
    """A NaN in q and one in dO reach, through the emulated kernel, every
    entry of dQ, dK and dV that depends on them (the card's case of
    ``test_torch_kernels_gpu``); the bare carry's rounding, which made the
    NaN a zero, did not."""
    shape = (1, 4, 2, 130, 64, 130, True, 0)
    b, h, kv, s, d, sk, causal, window = shape
    args = list(_k6_inputs(b, h, kv, s, sk, d, causal, window, seed=25)[1])
    args = [t.contiguous() for t in args]
    poison = [(0, (0, 1, s // 2, 3)), (4, (0, h - 1, s // 3, 5))]
    needed = GPU.nan_needed(lambda *a: ref.flash_attention_bwd_ref(
        *a, causal, window), args, poison)
    for i, index in poison:
        GPU.nan_at(args[i], index, bits)
    GPU.assert_nan_kept(("dq", "dk", "dv"),
                        emulate_k6(*args, causal, window), needed)


# --------------------------------------------------------- K7 backward

def emulate_k7(x, dt_a, b, c, dy, dst, ddecay, groups, heads, passes=3):
    """``ssd_bwd_tf32_kernel``'s arithmetic (module docstring) on fp32 x
    (BC, Q, H, P), dt_a (BC, Q, H), b, c (BC, Q, H, N) (each block's heads
    share one group's rows), the cotangents (None: zero); returns dx,
    d(dt_a), and dB, dC (BC, Q, groups, N)."""
    bc, q, h, p = x.shape
    n = b.shape[-1]
    cs = torch.cumsum(dt_a, dim=1)
    w = torch.exp(cs[:, -1:] - cs)
    tri = torch.ones(q, q, dtype=torch.bool).tril()        # [t, s]: s <= t
    dx, ddt = torch.zeros(bc, q, h, p), torch.zeros(bc, q, h)
    parts = []
    for h0 in range(0, h, heads):
        bt, ct = b[:, :, h0], c[:, :, h0]
        st = mma(bt, ct.transpose(-1, -2), passes=passes)   # Sᵀ[s, t]
        sum_ds = torch.zeros(bc, q, q)
        dba = torch.zeros(bc, q, n)
        for hd in range(h0, h0 + heads):
            xt = x[:, :, hd]
            yt = torch.zeros(bc, q, p) if dy is None else dy[:, :, hd]
            dt = torch.zeros(bc, p, n) if dst is None else dst[:, hd]
            seg = cs[:, None, :, hd] - cs[:, :, None, hd]   # [s, t]: cs_t − cs_s
            lt = torch.exp(seg.masked_fill(~tri.T, float("-inf")))
            wh = w[:, :, hd, None]
            dxh = wh * mma(bt, dt.transpose(-1, -2), passes=passes)
            dmt = mma(xt, yt.transpose(-1, -2), passes=passes)
            dst_ = dmt * lt
            sum_ds = sum_ds + dst_
            r = dst_ * st
            dx[:, :, hd] = mma(st * lt, yt, dxh, passes)
            f = mma(xt, dt, passes=passes)
            dw = (f * bt).sum(-1)
            dba = dba + wh * f
            dcs = r.sum(1) - r.sum(2) - dw * w[:, :, hd]
            if ddecay is not None:
                dcs = dcs + ddecay[:, :, hd] * torch.exp(cs[:, :, hd])
            dcs[:, -1] += (dw * w[:, :, hd]).sum(1)
            ddt[:, :, hd] = torch.flip(torch.cumsum(torch.flip(dcs, (1,)), 1),
                                       (1,))
        parts.append((mma(sum_ds, ct, dba, passes),
                      mma(sum_ds.transpose(-1, -2), bt, passes=passes)))
    per = (h // groups) // heads       # blocks a group
    db, dc = torch.zeros(bc, q, groups, n), torch.zeros(bc, q, groups, n)
    for gi in range(groups):
        for i in range(per):
            pb, pc = parts[gi * per + i]
            db[:, :, gi] = pb if i == 0 else db[:, :, gi] + pb
            dc[:, :, gi] = pc if i == 0 else dc[:, :, gi] + pc
    return dx, ddt, db, dc


def _k7_inputs(bc, q, h, p, n, g, seed):
    """fp32 numpy x, dt_a = −0.3·|N(0,1)|, b, c (BC, Q, G, N) and the
    cotangents dy, dstate, ddecay."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return (normal(bc, q, h, p), -np.abs(normal(bc, q, h)) * 0.3,
            normal(bc, q, g, n), normal(bc, q, g, n), normal(bc, q, h, p),
            normal(bc, h, p, n), normal(bc, q, h))


def _k7_port(arrays, h):
    x, dt_a, b, c, dy, dst, dd = (torch.from_numpy(a) for a in arrays)
    return (x, dt_a, ops.heads_of_groups(b, h), ops.heads_of_groups(c, h),
            dy, dst, dd)


# (BC, Q, H, P, N, G, heads a block): one B/C group over 4 heads at
# Zamba2's N and mamba2-2.7b's, heads a block 1, 2 and 4, per-head B/C, a
# ragged chunk
K7_CASES = {"zamba2 n64 4 a block": (2, 128, 4, 16, 64, 1, 4),
            "mamba2 n128 2 a block": (1, 128, 4, 16, 128, 1, 2),
            "grouped 1 a block": (2, 40, 6, 8, 16, 2, 1),
            "per-head ragged": (2, 77, 2, 32, 72, 2, 1)}


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_k7_fp32_kernel_arithmetic_meets_the_card_bars(case):
    """The emulated kernel against ``jax.vjp`` of the reference's
    ``ssd_chunk_ref`` (B and C repeated from their groups inside, so its
    transpose sums each group's heads), every gradient within phase 7's
    ``k7_bwd_close`` (dx, dB, dC 1e-4 of their largest, d(dt_a) 1e-5 + the
    noise floor)."""
    bc, q, h, p, n, g, heads = K7_CASES[case]
    arrays = _k7_inputs(bc, q, h, p, n, g, seed=31)
    x, dt_a, b, c, *cots = arrays

    def f(x, a, b, c):
        return jax.vmap(JR.ssd_chunk_ref)(x, a, jnp.repeat(b, h // g, axis=2),
                                         jnp.repeat(c, h // g, axis=2))

    outs, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (x, dt_a, b, c)))
    want = [torch.from_numpy(np.asarray(w, np.float32))
            for w in vjp(tuple(jnp.asarray(t) for t in cots))]
    port = _k7_port(arrays, h)
    got = emulate_k7(*port, g, heads)
    ok, _, crit = SMOKE.k7_bwd_close(torch, got, want,
                                     SMOKE.k7_bwd_noise(port[0], port[2],
                                                        port[3], *port[4:]))
    print(crit)
    assert ok, crit


@pytest.mark.parametrize("passes", [3, 1])
def test_k7_fp32_float64_witness(passes):
    """Phase 7's witness at (4 chunks of 128, 8 heads of 64, N = 64, one
    group, 4 heads a block): the emulated kernel within 8x the fp32 plain
    version's distance to the float64 plain version for every gradient;
    with one TF32 product a term, not."""
    shape = (4, 128, 8, 64, 64, 1)
    arrays = _k7_inputs(*shape, seed=33)
    port = _k7_port(arrays, shape[2])
    want = ref.ssd_chunk_bwd_ref(*port, 1)
    want64 = ref.ssd_chunk_bwd_ref(*(t.double() for t in port), 1)
    got = emulate_k7(*port, 1, 4, passes)
    ok, note = SMOKE.f64_witness(("dx", "ddt", "db", "dc"), got, want,
                                 want64)
    print(note)
    assert ok == (passes == 3), note


@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF])
def test_k7_fp32_kernel_arithmetic_keeps_nan(bits):
    """A NaN in x and one in dy reach, through the emulated kernel, every
    entry of dx, d(dt_a), dB and dC that depends on them."""
    shape = (2, 64, 4, 16, 16, 1)
    bc, q, h, p, n, g = shape
    args = [t.clone() for t in _k7_port(_k7_inputs(*shape, seed=37), h)]
    poison = [(0, (0, q // 2, 1, 3)), (4, (1, q // 3, h - 1, 5))]
    needed = GPU.nan_needed(lambda *a: ref.ssd_chunk_bwd_ref(*a, g), args,
                            poison)
    for i, index in poison:
        GPU.nan_at(args[i], index, bits)
    GPU.assert_nan_kept(("dx", "ddt", "db", "dc"),
                        emulate_k7(*args, g, 2), needed)


# ------------------------------------------------------ the host plans

def k6_smem(d: int) -> int:
    """``f32::Layout<kDPad>::kBytes``: K, V, two stages of (Q, dO, lse,
    delta) and dSᵀ, rows of kDPad + 4 floats."""
    pad = 64 if d <= 64 else 128
    tile = 64 * (pad + 4)
    return 4 * (2 * tile + 2 * (2 * tile + 128) + 64 * 68)


def k7_smem(n: int) -> int:
    """``ssd_bwd_f32::Layout<kNP>::kBytes``: B, S and ΣdS as fragments,
    the head buffers (two at N <= 64), the sums."""
    pad = 64 if n <= 64 else 128
    bufs = 2 if pad == 64 else 1
    head = 128 * 68 + 64 * (pad + 4)
    return 4 * (128 * (pad + 4) + 2 * 72 * 128 + bufs * head + 13 * 128)


@pytest.mark.parametrize("dim", [16, 64, 128])
def test_fp32_kernels_fit_one_block_an_sm(dim):
    """Each fp32 kernel's shared memory (the sources' layouts) fits a
    block's 232,448 bytes, one block an SM: K6 122,880 bytes at D <= 64
    and 221,184 at 128; K7 219,648 at N <= 64 (two head buffers) and
    216,576 at 128 (one); C fits where the head buffers lie."""
    want6 = {16: 122_880, 64: 122_880, 128: 221_184}[dim]
    want7 = {16: 219_648, 64: 219_648, 128: 216_576}[dim]
    assert k6_smem(dim) == want6 and k7_smem(dim) == want7
    for smem in (want6, want7):
        assert smem <= SMEM_PER_BLOCK and 2 * smem > SMEM_PER_SM
    pad = 64 if dim <= 64 else 128
    assert 128 * (pad + 4) <= (2 if pad == 64 else 1) * (
        128 * 68 + 64 * (pad + 4))


@pytest.mark.parametrize("arch", sorted(SMOKE.K7_PATHS))
def test_fp32_k7_heads_a_block_at_the_training_shapes(arch):
    """The fp32 kernel takes ``ssd_bwd_plan``'s heads as the bf16 one does:
    8 of Zamba2-1.2B's 64 and 10 of mamba2-2.7b's 80 (128 blocks, one wave
    at one block an SM); its 72 tiles a head (the lower triangle of 16 x 8
    tiles at Q = 128) split 18 a scheduler partition."""
    bc, q, h, p, n = SMOKE.K7_PATHS[arch]
    heads = ssd_bwd_plan(bc, h, q, 1, n)
    assert heads == {"zamba2-1.2b": 8, "mamba2-2.7b": 10}[arch]
    assert heads in SSD_BWD_HEADS and bc * h // heads == 128
    tiles = [16 - 2 * (w if w < 4 else 11 - w) for w in range(8)]
    assert sum(tiles) == 72
    assert all(tiles[w] + tiles[w + 4] == 18 for w in range(4))


@pytest.mark.parametrize("name", ["granite-3-2b train", "zamba2-1.2b train"])
def test_fp32_k6_units_at_the_training_shapes(name):
    """At the fp32 kernel's 64-key spans the causal walks of granite-3-2b
    and Zamba2-1.2B are cut into slices holding at least three units an
    SM, every unit within one (batch, KV head)'s span, and dK/dV's parts
    of a span ranked in list order."""
    b, h, kv, s, d, sk, causal, window = dict(SMOKE.K6_BWD_SHAPES)[name]
    sched = bwd_schedule(b, h, kv, s, sk, d, causal, window, BWD_F32_SPAN)
    assert sched.span == 64 and sched.n_units >= 3 * 132
    assert all(n * 64 < sk for n, *_ in sched.units)
    assert sched.plan()[:4] == [sched.units[0][0], sched.units[0][1],
                                sched.units[0][2],
                                sched.units[0][3] | sched.units[0][4] << 16]
