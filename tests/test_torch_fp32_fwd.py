"""The fp32 forwards of K6 and K7 on the tensor cores (3xTF32), on the CPU.

Both kernels (``csrc/flash_attention.cu`` ``flash_fwd_tf32_kernel``,
``csrc/ssd_scan.cu`` ``ssd_chunk_tf32_kernel``) take every product of fp32
operands as three TF32 products on ``mma.sync``, as the fp32 backwards do
(``test_torch_fp32_bwd.py``'s ``split`` and ``mma`` emulate the split and
the k8-step sums).  Their arithmetic is emulated here in torch, in their
order of sums:

  * K6: blocks of 128 query rows, K/V tiles of 64 keys (32 at D = 128)
    from the first tile of the block's first row's window; per tile S =
    Q·Kᵀ, the scaled and masked scores, the online rescale of m and l, the
    tile's P·V in a fresh accumulator with V split in three (hi_p·lo2_v
    first, then the three products of 3xTF32) and O = O·alpha + P·V; o =
    acc / l and lse = m + log l at the end;
  * K7: S = C·Bᵀ once a block (the heads of one B/C group share it), then
    each head's W = S∘exp(cs_t − cs_s) on s <= t, y = W·x, and the state
    (w∘x)ᵀ·B over the chunk's rows.

The same numpy inputs, made from a seed, go through the emulations and the
JAX reference: K6 against the Pallas kernel ``repro/kernels/
flash_attention.py:72`` in interpret mode (equal heads, Sq = Sk) and
``repro/models/layers.py``'s ``_sdpa`` under the mask (GQA, Sq != Sk, a
window, ragged lengths), its lse against ``_flash_fwd_core``; K7 against
the Pallas kernel ``repro/kernels/ssd_scan.py:60`` in interpret mode and
``repro/kernels/ref.py:122``'s ``ssd_chunk_ref``.  The bars are
chip_smoke.py phase 7's (``K6_FP32_RTOL``, ``K7_FP32_RTOL``,
``K6_LSE_TOL``), and so is its float64 witness: the emulated kernel's
distance to the plain version run in float64 is within ``F64_WITNESS``
(8x) of the fp32 plain version's, where one TF32 product a term lands far
past it.  Then NaN inputs, each kernel's shared memory against the H100's
232,448 bytes a block, fp32 K7's plan (the backward's, ``ssd_bwd_plan``)
and the costs.  The CUDA kernels
themselves are held to the plain versions on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py phase 7).
"""

import importlib
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.models import layers as JL
from repro_torch.core.planner import H100Target
from repro_torch.kernels import cost, ref, ssd_scan
from repro_torch.kernels.ssd_scan import (SSD_BWD_HEADS, ssd_bwd_plan,
                                          ssd_chunk)

import test_torch_kernels_gpu as GPU

# the reference's kernel modules (the package's names are their functions)
JF = importlib.import_module("repro.kernels.flash_attention")
JS = importlib.import_module("repro.kernels.ssd_scan")
from test_torch_fp32_bwd import mma, split

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)

SMEM_PER_BLOCK = 232_448    # the H100's opt-in shared memory a block


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread beats 8 contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got: torch.Tensor, want) -> float:
    """Max abs error over the largest |want| (chip_smoke.errors)."""
    return SMOKE.errors(got, torch.as_tensor(np.asarray(want)))[1]


# ---------------------------------------------------------- K6 forward

def mma_pv(p, v, passes=3, lo2=True):
    """A tile's P·V as the kernel takes it from zero: eight keys a step,
    v = hi + lo + lo2 exactly (lo2 the bits the truncated lo drops) and
    hi_p·lo2 (where ``lo2``), lo_p·hi, hi_p·lo, hi_p·hi summed in that
    order; ``passes`` 1: hi_p·hi alone."""
    (ph, pl), (vh, vl) = split(p), split(v)
    v2 = v - vh - vl
    d = torch.zeros(*p.shape[:-1], v.shape[-1])
    for k0 in range(0, p.shape[-1], 8):
        k = slice(k0, k0 + 8)
        if passes == 3:
            if lo2:
                d = d + ph[..., k] @ v2[..., k, :]
            d = d + pl[..., k] @ vh[..., k, :]
            d = d + ph[..., k] @ vl[..., k, :]
        d = d + ph[..., k] @ vh[..., k, :]
    return d


def emulate_k6(q, k, v, causal, window, passes=3, lo2=True):
    """``flash_fwd_tf32_kernel``'s arithmetic (module docstring) on fp32 q
    (B, H, Sq, D), k, v (B, KV, Sk, D); returns (o, lse)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    tile = 32 if d > 64 else 64
    scale = (1.0 / torch.tensor(float(d)).sqrt()).item()   # 1.0f / sqrtf(D)
    keep = (ref.attention_mask(sq, sk, window, "cpu") if causal
            else torch.ones(sq, sk, dtype=torch.bool))
    qg = q.reshape(b, kv, g, sq, d)
    kt, vt = k[:, :, None], v[:, :, None]
    o = torch.zeros(b, kv, g, sq, d)
    lse = torch.zeros(b, kv, g, sq)
    for q0 in range(0, sq, 128):
        rows = slice(q0, min(q0 + 128, sq))
        kv_end = min(sk, q0 + 128) if causal else sk
        kv_begin = max(0, q0 - window + 1) // tile * tile if window else 0
        n = rows.stop - q0
        m = torch.full((b, kv, g, n), -1e30)
        l_ = torch.zeros(b, kv, g, n)
        acc = torch.zeros(b, kv, g, n, d)
        for kv0 in range(kv_begin, kv_end, tile):
            keys = slice(kv0, min(kv0 + tile, sk))
            s = mma(qg[:, :, :, rows], kt[:, :, :, keys].transpose(-1, -2),
                    passes=passes) * scale
            s = torch.where(keep[rows, keys], s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l_ = l_ * alpha + p.sum(-1)
            pv = mma_pv(p, vt[:, :, :, keys], passes, lo2)
            acc = torch.addcmul(pv, acc, alpha[..., None])
            m = m_new
        o[:, :, :, rows] = acc / l_[..., None]
        lse[:, :, :, rows] = m + torch.log(l_)
    return o.reshape(b, h, sq, d), lse.reshape(b, h, sq)


def _k6_inputs(b, h, kv, s, sk, d, seed):
    """q, k, v fp32 numpy in the reference's (B, S, heads, D) layout and
    the port's (B, heads, S, D) views of them."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, kv, d)).astype(np.float32)
            for _ in range(2))
    return (q, k, v), tuple(torch.from_numpy(a).transpose(1, 2)
                            for a in (q, k, v))


# (B, H, KV, S, D, Sk, causal, window): equal heads at the Pallas kernel's
# blocks (causal and full), then through _sdpa: GQA over ragged tiles at D
# = 128 (32-key tiles), cross-attention with Sq != Sk, a window across
# tiles and 128-row blocks, one query
K6_CASES = {"pallas causal": (1, 4, 4, 256, 64, 256, True, 0),
            "pallas full": (2, 2, 2, 256, 32, 256, False, 0),
            "gqa d128 ragged": (1, 4, 2, 200, 128, 200, True, 0),
            "cross": (2, 2, 2, 70, 16, 150, False, 0),
            "window": (1, 4, 4, 300, 64, 300, True, 37),
            "gqa window d96": (1, 6, 2, 260, 96, 260, True, 65),
            "one query": (1, 4, 1, 1, 64, 1, True, 0)}


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_fp32_kernel_arithmetic_meets_the_card_bars(case):
    """The emulated kernel against the reference (the Pallas kernel in
    interpret mode where it takes the shape, else ``_sdpa`` under the
    mask): o within phase 7's K6_FP32_RTOL of its largest element."""
    b, h, kv, s, d, sk, causal, window = K6_CASES[case]
    (q, k, v), port = _k6_inputs(b, h, kv, s, sk, d, seed=41)
    if case.startswith("pallas"):
        tr = [jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)]
        want = np.asarray(JF.flash_attention(*tr, causal=causal, block_q=128,
                                             block_kv=128, interpret=True))
        want = want.transpose(0, 2, 1, 3)
    else:
        mask = (ref.attention_mask(s, sk, window, "cpu").numpy() if causal
                else np.ones((s, sk), bool))
        want = np.asarray(JL._sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                                   jnp.asarray(mask)))
    got, _ = emulate_k6(*port, causal, window)
    err = _rel(got.transpose(1, 2), want)
    print(f"o {err:.2e} of its largest (bar {SMOKE.K6_FP32_RTOL:g})")
    assert err <= SMOKE.K6_FP32_RTOL


@pytest.mark.parametrize("groups", [1, 4])
def test_k6_fp32_lse_matches_flash_fwd_core(groups):
    """The emulated kernel's lse against the reference's
    ``_flash_fwd_core`` (causal, one 128-key chunk a step) within phase
    7's K6_LSE_TOL·(1 + |ref|), and its o with the lse the same as
    without."""
    b, kv, s, d = 1, 2, 256, 64
    (q, k, v), port = _k6_inputs(b, kv * groups, kv, s, s, d, seed=43)
    qg = jnp.asarray(q).reshape(b, s, kv, groups, d)
    kc, vc = (jnp.asarray(a).reshape(b, s // 128, 128, kv, d) for a in (k, v))
    _, want = JL._flash_fwd_core(qg, kc, vc, 128, 1)      # (B, KV, G, L)
    o, lse = emulate_k6(*port, True, 0)
    want = torch.from_numpy(np.asarray(want)).reshape(b, kv * groups, s)
    err = ((lse - want).abs() / (1 + want.abs())).max().item()
    print(f"lse {err:.2e} (bar {SMOKE.K6_LSE_TOL:g})")
    assert err <= SMOKE.K6_LSE_TOL
    assert _rel(o, ref.flash_attention_ref(*port)) <= SMOKE.K6_FP32_RTOL


@pytest.mark.parametrize("passes", [3, 1])
def test_k6_fp32_float64_witness(passes):
    """Phase 7's witness at (1, 8 on 2, 256, 64) causal: the emulated
    kernel's distance to the plain version in float64 is within 8x the
    fp32 plain version's (``chip_smoke.f64_witness``); with one TF32
    product a term it is not."""
    _, port = _k6_inputs(1, 8, 2, 256, 256, 64, seed=45)
    want = ref.flash_attention_ref(*port)
    want64 = ref.flash_attention_ref(*(t.double() for t in port))
    assert want64.dtype == torch.float64
    got, _ = emulate_k6(*port, True, 0, passes)
    ok, note = SMOKE.f64_witness(("o",), (got,), (want,), (want64,))
    print(note)
    assert ok == (passes == 3), note


@pytest.mark.parametrize("lo2", [True, False])
def test_k6_fp32_window_one_returns_v_exactly(lo2):
    """With a window of 1 each row keeps its own key alone, p = 1 exactly,
    and the emulated kernel returns v bit for bit (phase 7's ``exact``,
    the card's window test): v's three pieces sum to it exactly.  Split in
    two, hi + lo (3xTF32 alone), it does not."""
    _, port = _k6_inputs(1, 4, 2, 200, 200, 64, seed=49)
    got, _ = emulate_k6(*port, True, 1, lo2=lo2)
    want = port[2].repeat_interleave(2, dim=1)
    assert torch.equal(got, want) == lo2


@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF])
def test_k6_fp32_kernel_arithmetic_keeps_nan(bits):
    """A NaN in q, one in k and one in v reach, through the emulated
    kernel, every entry of o that depends on them (as the card's case of
    ``test_torch_kernels_gpu`` holds the kernel)."""
    b, h, kv, s, d = 1, 4, 2, 200, 64
    args = [t.contiguous() for t in _k6_inputs(b, h, kv, s, s, d, 47)[1]]
    poison = [(0, (0, 1, s // 2, 3)), (1, (0, 1, s // 3, 5)),
              (2, (0, 0, s // 4, 7))]
    needed = GPU.nan_needed(lambda *a: (ref.flash_attention_ref(*a, True),),
                            args, poison)
    for i, index in poison:
        GPU.nan_at(args[i], index, bits)
    GPU.assert_nan_kept(("o",), (emulate_k6(*args, True, 0)[0],), needed)


# ---------------------------------------------------------- K7 forward

def f32_plan(bc, h, q, shared, n):
    """fp32 K7's heads a block: the backward's plan over one group where
    B and C are shared, one a head else (``ssd_scan.ssd_chunk``)."""
    return ssd_bwd_plan(bc, h, q, 1 if shared else h, n)


def emulate_k7(x, dt_a, b, c, heads, passes=3):
    """``ssd_chunk_tf32_kernel``'s arithmetic (module docstring) on fp32 x
    (BC, Q, H, P), dt_a (BC, Q, H), b, c (BC, Q, H, N), each block's
    ``heads`` sharing the first one's B and C; returns (y, state,
    decay)."""
    bc, q, h, p = x.shape
    n = b.shape[-1]
    cs = torch.cumsum(dt_a, dim=1)
    w = torch.exp(cs[:, -1:] - cs)
    tri = torch.ones(q, q, dtype=torch.bool).tril()          # [t, s]: s <= t
    y, state = torch.zeros(bc, q, h, p), torch.zeros(bc, h, p, n)
    for h0 in range(0, h, heads):
        bt, ct = b[:, :, h0], c[:, :, h0]
        s_ = mma(ct, bt.transpose(-1, -2), passes=passes)      # S[t, s]
        for hd in range(h0, h0 + heads):
            seg = cs[:, :, None, hd] - cs[:, None, :, hd]      # cs_t − cs_s
            wt = torch.where(tri, s_ * torch.exp(seg), 0.0)
            y[:, :, hd] = mma(wt, x[:, :, hd], passes=passes)
            wx = w[:, :, hd, None] * x[:, :, hd]
            state[:, hd] = mma(wx.transpose(-1, -2), bt, passes=passes)
    return y, state, torch.exp(cs)


def _k7_inputs(bc, q, h, p, n, shared, seed):
    """fp32 numpy x, dt_a = −0.3·|N(0,1)|, and b, c with one group (shared)
    or one a head; the port's tensors, B and C a stride-0 view where
    shared."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    g = 1 if shared else h
    arrays = (normal(bc, q, h, p), -np.abs(normal(bc, q, h)) * 0.3,
              normal(bc, q, g, n), normal(bc, q, g, n))
    x, dt_a, b, c = (torch.from_numpy(a) for a in arrays)
    if shared:
        b, c = (t.expand(bc, q, h, n) for t in (b, c))
    return arrays, (x, dt_a, b, c)


# (BC, Q, H, P, N, shared B/C): one B/C group over 8 heads at Zamba2's N,
# 4 at mamba2-2.7b's N = 128, a ragged chunk with N = 72 and P < 64 per
# head, N = 96, and a stride-0 ragged chunk at N = 128
K7_CASES = {"zamba2 n64": (2, 128, 8, 16, 64, True),
            "mamba2 n128": (1, 128, 4, 16, 128, True),
            "per-head ragged n72": (2, 77, 2, 32, 72, False),
            "per-head n96": (1, 64, 2, 30, 96, False),
            "shared ragged n128": (2, 100, 4, 64, 128, True)}


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_k7_fp32_kernel_arithmetic_meets_the_card_bars(case):
    """The emulated kernel at the fp32 plan's heads a block against the
    reference's Pallas kernel in interpret mode and its ``ssd_chunk_ref``
    (B and C repeated from their groups): y, state and decay each within
    phase 7's K7_FP32_RTOL of their largest element."""
    bc, q, h, p, n, shared = K7_CASES[case]
    arrays, port = _k7_inputs(bc, q, h, p, n, shared, seed=51)
    x, dt_a, b, c = (jnp.asarray(a) for a in arrays)
    b, c = (jnp.repeat(t, h // t.shape[2], axis=2) for t in (b, c))
    heads = f32_plan(bc, h, q, shared, n)
    got = emulate_k7(*port, heads)
    for want in (JS.ssd_chunk(x, dt_a, b, c, interpret=True),
                 jax.vmap(JR.ssd_chunk_ref)(x, dt_a, b, c)):
        for name, g_, w in zip(("y", "state", "decay"), got, want):
            err = _rel(g_, w)
            print(f"{name} {err:.2e} of its largest (bar "
                  f"{SMOKE.K7_FP32_RTOL:g})")
            assert err <= SMOKE.K7_FP32_RTOL, name


@pytest.mark.parametrize("heads", [1, 2, 4, 8])
def test_k7_fp32_any_heads_a_block_gives_the_same(heads):
    """S formed once a block from the first head's stride-0 B and C is the
    S of every head of the block: the emulated kernel's outputs do not
    depend on the heads a block."""
    _, port = _k7_inputs(2, 128, 8, 16, 64, True, seed=53)
    one = emulate_k7(*port, 1)
    for a, b_ in zip(one, emulate_k7(*port, heads)):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("passes", [3, 1])
def test_k7_fp32_float64_witness(passes):
    """Phase 7's witness at (4 chunks of 128, 8 heads of 64, N = 64, one
    group, 8 heads a block): y and the state within 8x the fp32 plain
    version's distance to the float64 plain version (the decay is not a
    product); with one TF32 product a term, not."""
    _, port = _k7_inputs(4, 128, 8, 64, 64, True, seed=55)
    want = ref.ssd_chunk_ref(*port)
    want64 = ref.ssd_chunk_ref(*(t.double() for t in port))
    assert want64[0].dtype == torch.float64
    got = emulate_k7(*port, 8, passes)
    ok, note = SMOKE.f64_witness(("y", "state", "decay"), got, want, want64)
    print(note)
    assert ok == (passes == 3), note


@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF])
@pytest.mark.parametrize("shared", [True, False])
def test_k7_fp32_kernel_arithmetic_keeps_nan(bits, shared):
    """A NaN in x, one in B and one in C (in the group's one row where B
    and C are shared, so every head reads it) reach, through the emulated
    kernel, every entry of y and the state that depends on them."""
    bc, q, h, p, n = 2, 64, 4, 16, 16
    arrays, _ = _k7_inputs(bc, q, h, p, n, shared, seed=57)
    args = [torch.from_numpy(a.copy()) for a in arrays]

    def heads_of(x, dt_a, b, c):
        return (x, dt_a, *(t.expand(bc, q, h, n) if shared else t
                           for t in (b, c)))

    poison = [(0, (0, q // 2, 1, 3)), (2, (1, q // 3, 0, 5)),
              (3, (1, q // 2, 0, 7))]
    needed = GPU.nan_needed(lambda *a: ref.ssd_chunk_ref(*heads_of(*a)),
                            args, poison)
    for i, index in poison:
        GPU.nan_at(args[i], index, bits)
    got = emulate_k7(*heads_of(*args), f32_plan(bc, h, q, shared, n))
    GPU.assert_nan_kept(("y", "state"), got[:2], needed[:2])


# ------------------------------------------------------ the host plans

def k6_smem(d: int) -> int:
    """``f32::Layout<kDPad>::kBytes`` (flash_attention.cu): Q's hi and lo
    fragments of 8 warps, then the ring: three stages of 64-key K and V
    tiles at D <= 64, two of 32-key tiles at 128, rows of kDPad + 4."""
    pad = 64 if d <= 64 else 128
    keys, stages = (64, 3) if pad == 64 else (32, 2)
    return 4 * (2 * 8 * (pad // 8) * 128 + stages * 2 * keys * (pad + 4))


def k7_smem(n: int) -> int:
    """``ssd_f32::Layout<kNP>::kBytes`` (ssd_scan.cu): B, C or S's 72
    fragment tiles (the larger), two x buffers of rows of 68, each of 16
    heads' cs and w."""
    pad = 64 if n <= 64 else 128
    return 4 * (128 * (pad + 4) + max(128 * (pad + 4), 72 * 128)
                + 2 * 128 * 68 + 2 * 16 * 128)


@pytest.mark.parametrize("dim", [16, 64, 128])
def test_fp32_fwd_kernels_fit_one_block_an_sm(dim):
    """Each fp32 forward's shared memory (the sources' layouts) fits a
    block's 232,448 bytes: K6 169,984 bytes at D <= 64 and 198,656 at 128;
    K7 157,696 at N <= 64 (S's fragments pass C's 34,816 bytes there) and
    221,184 at 128."""
    want6 = {16: 169_984, 64: 169_984, 128: 198_656}[dim]
    want7 = {16: 157_696, 64: 157_696, 128: 221_184}[dim]
    assert k6_smem(dim) == want6 and k7_smem(dim) == want7
    for smem in (want6, want7):
        assert smem <= SMEM_PER_BLOCK
    assert 72 * 128 * 4 > 128 * 68 * 4 and 72 * 128 <= 128 * 132


@pytest.mark.parametrize("arch", sorted(SMOKE.K7_PATHS))
def test_fp32_k7_heads_a_block_at_the_paths(arch):
    """The fp32 plan at the serving and training paths' K7 shapes: 8 of
    Zamba2-1.2B's 64 heads and 10 of mamba2-2.7b's 80 (128 blocks, one wave
    on 132 SMs); per-head B and C: one head a block; the 72 tiles of S's
    lower part split 18 a scheduler partition (warps w and w + 4 own row
    blocks w and 7 − w)."""
    bc, q, h, p, n = SMOKE.K7_PATHS[arch]
    heads = f32_plan(bc, h, q, True, n)
    assert heads == {"zamba2-1.2b": 8, "mamba2-2.7b": 10}[arch]
    assert bc * h // heads == 128 and f32_plan(bc, h, q, False, n) == 1
    tiles = [2 * (w if w < 4 else 11 - w) + 2 for w in range(8)]
    assert sum(tiles) == 72
    assert all(tiles[w] + tiles[w + 4] == 18 for w in range(4))


@pytest.mark.parametrize("bc,h", [(1, 64), (4, 64), (8, 64), (16, 64),
                                  (4, 80), (8, 80), (16, 80), (3, 6),
                                  (2, 7), (1, 1)])
def test_fp32_k7_plan_fits_the_kernel(bc, h):
    """The plan is one of SSD_BWD_HEADS dividing H and at most 16, the
    kernel's room for each head's cs and w (``ssd_f32::kMaxHeads``), and
    at the phase-7 shapes the one chip_smoke.py's sweep found fastest on
    an NVIDIA H100 80GB HBM3 at 700 W: 2, 4, 8 at 4, 8, 16 chunks of
    Zamba2's heads, 4, 5, 10 of mamba2-2.7b's (PERF.md §6)."""
    heads = f32_plan(bc, h, 128, True, 128 if h == 80 else 64)
    assert heads in SSD_BWD_HEADS and h % heads == 0 and heads <= 16
    fastest = {(4, 64): 2, (8, 64): 4, (16, 64): 8, (4, 80): 4, (8, 80): 5,
               (16, 80): 10, (1, 64): 1}
    assert heads == fastest.get((bc, h), heads)


@pytest.mark.parametrize("shared", [True, False])
def test_ssd_chunk_hands_the_fp32_kernel_its_plan(shared, monkeypatch):
    """On the card the fp32 wrapper launches the 3xTF32 kernel with the
    backward's plan's heads (one a block for per-head B and C), counted
    once in ``launches``; run here against a stand-in extension."""
    bc, q, h, p, n = 16, 128, 64, 64, 64
    _, (x, dt_a, b, c) = _k7_inputs(bc, q, h, p, n, shared, seed=59)
    seen = []
    monkeypatch.setattr(ssd_scan, "device_type", lambda *a: "cuda")
    monkeypatch.setattr(ssd_scan._build, "extension", lambda: SimpleNamespace(
        ssd_chunk=lambda *a: seen.append(a)))
    before = ssd_chunk.launches
    y, state, decay = ssd_chunk(x, dt_a, b, c)
    (args,) = seen
    assert args[-1] == (8 if shared else 1) and ssd_chunk.launches == before + 1
    assert y.shape == x.shape and state.shape == (bc, h, p, n)


def test_fp32_forward_costs_price_3xtf32():
    """fp32 K6 and K7 count each product as three TF32 products, priced at
    the tensor cores' 495 TFLOP/s: K6 at Zamba2-1.2B's (1, 32, 2048, 64)
    causal 17.19 GFLOP and 0.10417 ms (on the CUDA cores the same products
    would take 0.25654); K7 at Zamba2's (16 chunks of 128, 64 heads of 64,
    N = 64, one group) bound by its 86 MB at 0.02567 ms, at mamba2-2.7b's
    (80 heads, N = 128) by its operations, 0.04086 ms, S counted once a
    head.  bf16 is unchanged."""
    target = H100Target()
    f = cost.flash_attention(1, 32, 32, 2048, 2048, 64, 4, True)
    bf = cost.flash_attention(1, 32, 32, 2048, 2048, 64, 2, True)
    assert f.flops == {"tfloat32": 3 * bf.flops["bfloat16"]}
    assert round(bf.flops["bfloat16"] / 1e9, 2) == 17.19
    ops_s, bytes_s = f.seconds(target)
    assert ops_s > bytes_s and round(ops_s * 1e3, 5) == 0.10417
    assert round(bf.flops["bfloat16"] / target.flop_rate("float32") * 1e3,
                 5) == 0.25654
    z = cost.ssd_chunk(16, 128, 64, 64, 64, 1, 4)
    zb = cost.ssd_chunk(16, 128, 64, 64, 64, 1, 2)
    assert z.flops == {"tfloat32": 3 * zb.flops["bfloat16"]}
    ops_s, bytes_s = z.seconds(target)
    assert bytes_s > ops_s and round(bytes_s * 1e3, 5) == 0.02567
    assert round(z.nbytes / 1e6) == 86
    m = cost.ssd_chunk(16, 128, 80, 64, 128, 1, 4)
    ops_s, bytes_s = m.seconds(target)
    assert ops_s > bytes_s and round(ops_s * 1e3, 5) == 0.04086
