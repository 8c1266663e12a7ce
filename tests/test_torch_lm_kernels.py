"""The port's LM-prefill kernel modules — flash attention (K6) and the
SSD intra-chunk term (K7) — against the JAX reference.

The same numpy inputs go through the JAX ops (``force="ref"`` and
``force="pallas_interpret"``, outside any mesh, as tests/test_kernels.py
runs them) and through the port's wrappers on CPU tensors, which run the
plain versions.  Tolerances are tests/test_kernels.py's: 2e-5 (fp32) and
5e-2 (bf16) for attention, 1e-5 for the SSD chunk.  The CUDA kernels are
held against the plain versions on the card in
tests/test_torch_kernels_gpu.py, the ``gpu`` cases at the end of this
file (K7 at N = 72-128, K6 with Sq != Sk, the Mamba2 LM, encoder-decoder
and VLM smoke models) and chip_smoke.py.  The bf16 SSD kernel's
arithmetic (tensor-core products with the weights split into bf16 hi +
lo) is emulated here in torch and held to chip_smoke.py's own bars.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import SSD_MIN_BLOCKS, ssd_chunk, ssd_plan

# tests/test_kernels.py's shapes: (b, h, s, d, block) and (bc, q, h, p, n, bh)
FLASH_SHAPES = [(1, 2, 128, 32, 64), (2, 4, 256, 64, 128), (1, 1, 64, 128, 32)]
SSD_SHAPES = [(2, 16, 8, 8, 4, 4), (1, 32, 4, 16, 8, 4), (3, 8, 16, 8, 16, 8)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread beats 8 contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


def _qkv(b, h, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [_np(rng, (b, h, s, d)) for _ in range(3)]


@pytest.mark.parametrize("b,h,s,d,bq", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_plain_matches_reference(b, h, s, d, bq, causal,
                                                 dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _qkv(b, h, s, d)
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in arrs),
                                causal=causal, force="ref")
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrs),
                          causal)
    assert got.dtype == tdt and got.shape == (b, h, s, d)
    _close(got, want, tol)


@pytest.mark.parametrize("b,h,s,d,bq", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas_kernel(b, h, s, d, bq, causal):
    jdt, tdt, tol = DTYPES["float32"]
    arrs = _qkv(b, h, s, d, seed=1)
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in arrs),
                                causal=causal, force="pallas_interpret",
                                block_q=bq, block_kv=bq)
    got = flash_attention(*(torch.from_numpy(a) for a in arrs), causal)
    _close(got, want, tol)


def test_flash_attention_bf16_matches_pallas_kernel():
    b, h, s, d, bq = FLASH_SHAPES[1]
    arrs = _qkv(b, h, s, d, seed=2)
    want = jops.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in arrs),
                                causal=True, force="pallas_interpret",
                                block_q=bq, block_kv=bq)
    got = flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                            for a in arrs), True)
    _close(got, want, 5e-2)


def test_flash_attention_reads_transposed_views():
    """The model passes (B, S, H, D) projections as (B, H, S, D) views."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 3, 40, 16, seed=3))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(flash_attention(*views, True),
                               ref.flash_attention_ref(q, k, v, True),
                               rtol=0, atol=0)


def _ssd_inputs(bc, q, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = _np(rng, (bc, q, h, p))
    dt_a = -np.abs(_np(rng, (bc, q, h))) * 0.3
    return x, dt_a, _np(rng, (bc, q, h, n)), _np(rng, (bc, q, h, n))


def _ssd_close(ours, theirs, tol=1e-5):
    for o, t in zip(ours, theirs):
        _close(o, t, tol)


@pytest.mark.parametrize("bc,q,h,p,n,bh", SSD_SHAPES)
def test_ssd_chunk_plain_matches_reference_and_pallas_kernel(bc, q, h, p, n,
                                                             bh):
    arrs = _ssd_inputs(bc, q, h, p, n)
    jarrs = [jnp.asarray(a) for a in arrs]
    got = ssd_chunk(*(torch.from_numpy(a) for a in arrs))
    assert [t.dtype for t in got] == [torch.float32] * 3
    assert [tuple(t.shape) for t in got] == [(bc, q, h, p), (bc, h, p, n),
                                             (bc, q, h)]
    _ssd_close(got, jops.ssd_chunk(*jarrs, force="ref"))
    _ssd_close(got, jops.ssd_chunk(*jarrs, force="pallas_interpret",
                                   block_h=bh))


@pytest.mark.parametrize("bc,q,h,p,n,bh", SSD_SHAPES)
def test_ssd_chunk_takes_stride0_broadcast_groups(bc, q, h, p, n, bh):
    """One group's B and C broadcast to every head as expanded views (head
    stride 0), against the reference fed the materialised broadcast."""
    x, dt_a, b, c = _ssd_inputs(bc, q, h, p, n, seed=4)
    b1, c1 = b[:, :, :1], c[:, :, :1]
    tb = torch.from_numpy(b1).expand(bc, q, h, n)
    tc = torch.from_numpy(c1).expand(bc, q, h, n)
    assert tb.stride(2) == 0
    got = ssd_chunk(torch.from_numpy(x), torch.from_numpy(dt_a), tb, tc)
    want = jops.ssd_chunk(jnp.asarray(x), jnp.asarray(dt_a),
                          jnp.asarray(np.broadcast_to(b1, b.shape)),
                          jnp.asarray(np.broadcast_to(c1, c.shape)),
                          force="ref")
    _ssd_close(got, want)


def test_ops_dispatch_on_cpu_runs_the_plain_versions():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 24, 8, seed=5))
    x, dt_a, b, c = (torch.from_numpy(a) for a in _ssd_inputs(2, 8, 2, 4, 4))
    before = ops.launch_counts()
    assert {"flash_attention", "ssd_chunk"} <= set(ops.KERNELS)
    for mode in (None, "ref"):
        torch.testing.assert_close(ops.flash_attention(q, k, v, mode=mode),
                                   ref.flash_attention_ref(q, k, v))
        for got, want in zip(ops.ssd_chunk(x, dt_a, b, c, mode=mode),
                             ref.ssd_chunk_ref(x, dt_a, b, c)):
            torch.testing.assert_close(got, want)
    assert ops.launch_counts() == before        # no kernel on CPU tensors
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_attention(q, k, v, mode="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.ssd_chunk(x, dt_a, b, c, mode="cuda")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 2, 8, 16)
    x, dt_a, b = torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2), torch.zeros(1, 8, 2, 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_chunk(x.half(), dt_a, b.half(), b.half())
    with pytest.raises(TypeError, match="mixed dtypes"):
        flash_attention(q, q.bfloat16(), q)
    # GQA takes KV dividing H (tests/test_torch_gqa.py); 3 heads do not
    # divide 2; keys of another length are cross-attention, which is not
    # causal (tests/test_torch_encdec.py), and k and v must agree
    with pytest.raises(ValueError, match="H % KV == 0"):
        flash_attention(torch.zeros(1, 3, 8, 16), q, q)
    with pytest.raises(ValueError, match="causal attention needs Sq == Sk"):
        flash_attention(q, q[:, :, :4], q[:, :, :4])
    with pytest.raises(ValueError, match="k and v must"):
        flash_attention(q, q[:, :, :4], q, causal=False)
    with pytest.raises(ValueError, match="D <= 128"):
        big = torch.zeros(1, 1, 4, 130)
        flash_attention(big, big, big)
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3))
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q.requires_grad_(True), q, q)
    with pytest.raises(ValueError, match="dt_a has shape"):
        ssd_chunk(x, dt_a[:, :4], b, b)


def _bf16_views(kind):
    """(B, H, S, D) bf16 views the TMA-fed kernel cannot load: a row
    stride of 66 bytes, or a base 2 bytes past a 16-byte boundary."""
    if kind == "row stride":
        return torch.zeros(1, 2, 8, 33, dtype=torch.bfloat16)[..., :32]
    flat = torch.zeros(1 + 2 * 8 * 32, dtype=torch.bfloat16)
    return flat[1:].view(1, 2, 8, 32)


@pytest.mark.parametrize("kind", ["row stride", "base"])
def test_flash_attention_refuses_misaligned_bf16_views(kind):
    """In bf16 the wrapper refuses, before its device dispatch, views the
    kernel's TMA loads cannot take (16-byte aligned base and strides); fp32
    views of the same layout still run (the fp32 kernel loads by thread)."""
    t = _bf16_views(kind)
    assert t.data_ptr() % 16 or t.stride(2) * 2 % 16
    ops.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(t, t, t)
    assert ops.launch_counts()["flash_attention"] == 0
    f = t.float()
    torch.testing.assert_close(flash_attention(f, f, f),
                               ref.flash_attention_ref(f, f, f))


@pytest.mark.parametrize("bc,q,h,p,n", [(1, 129, 2, 8, 8), (1, 8, 2, 65, 8),
                                        (1, 8, 2, 8, 129)])
def test_ssd_chunk_refuses_shapes_beyond_the_kernel(bc, q, h, p, n):
    """Q <= 128, P <= 64 and N <= 128 (the chunk and head sizes of Zamba2
    and Mamba2-2.7B), on either device, so the CPU path takes what the
    kernel takes."""
    x, dt_a = torch.zeros(bc, q, h, p), torch.zeros(bc, q, h)
    b = torch.zeros(bc, q, h, n)
    with pytest.raises(ValueError, match="Q <= 128, P <= 64, N <= 128"):
        ssd_chunk(x, dt_a, b, b)


# ---- the bf16 SSD kernel's host plan and arithmetic ---------------------

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)


@pytest.mark.parametrize("bc", [1, 4, 8, 16])
@pytest.mark.parametrize("shared_bc", [True, False])
def test_ssd_plan_fills_the_card(bc, shared_bc):
    """Heads a block walks at Zamba2's H = 64, Q = 128 (one chunk and the
    512/1024/2048-token prompt buckets): a divisor of H of at most 8; with
    stride-0 B/C the largest whose grid still holds SSD_MIN_BLOCKS (3/4 of
    two blocks on each of 132 SMs), so twice as many heads would not; with
    per-head B/C, where nothing is staged once for several heads, one."""
    h = 64
    heads = ssd_plan(bc, h, 128, shared_bc)
    assert heads in (1, 2, 4, 8) and h % heads == 0
    assert heads == ({1: 1, 4: 1, 8: 2, 16: 4}[bc] if shared_bc else 1)
    if shared_bc:
        assert heads == 1 or bc * h // heads >= SSD_MIN_BLOCKS
        assert bc * h // (2 * heads) < SSD_MIN_BLOCKS


def test_ssd_plan_refuses_chunks_beyond_the_kernel():
    with pytest.raises(ValueError, match="chunk 129"):
        ssd_plan(16, 64, 129, True)


def _k7_bf16_emulation(x, dt_a, b, c, split=True):
    """csrc/ssd_scan.cu's bf16 arithmetic in torch: S = C·Bᵀ in fp32 from
    the bf16 inputs (the tensor cores' exact products, fp32 sums); the
    decay mask W = S ∘ exp(cs_t − cs_s) on s <= t in fp32; W and
    w∘B (w_s = exp(cs_{Q-1} − cs_s)) as bf16 hi + lo (or one bf16 rounding
    where ``split`` is False); fp32 sums; y rounded to x's dtype."""
    xf, bf, cf = x.float(), b.float(), c.float()
    q = x.shape[1]
    cs = torch.cumsum(dt_a.float(), dim=1)                       # (BC, Q, H)
    csh = cs.permute(0, 2, 1)                                    # (BC, H, Q)
    s = torch.einsum("bthn,bshn->bhts", cf, bf)
    mask = torch.ones((q, q), dtype=torch.bool).tril()
    w = torch.where(mask, s * torch.exp(csh[..., :, None] - csh[..., None, :]),
                    torch.zeros(()))

    def parts(v):
        hi = v.bfloat16().float()
        return (hi, (v - hi).bfloat16().float()) if split else (hi,)

    y = sum(torch.einsum("bhts,bshp->bthp", part, xf) for part in parts(w))
    wb = torch.exp(cs[:, -1:, :] - cs)[..., None] * bf           # (BC, Q, H, N)
    state = sum(torch.einsum("bshp,bshn->bhpn", xf, part) for part in parts(wb))
    return y.to(x.dtype), state, torch.exp(cs)


def _k7_serving_inputs(seed):
    """(BC=2, Q=128, H=4, P=N=64) bf16 with one B/C group broadcast to the
    heads as stride-0 views, dt_a = −0.3·|N(0,1)| as chip_smoke.py's."""
    bc, q, h, p, n = 2, 128, 4, 64, 64
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_np(rng, (bc, q, h, p))).bfloat16()
    dt_a = torch.from_numpy(-np.abs(_np(rng, (bc, q, h))) * 0.3)
    b1, c1 = (torch.from_numpy(_np(rng, (bc, q, 1, n))).bfloat16()
              for _ in range(2))
    return x, dt_a, b1.expand(bc, q, h, n), c1.expand(bc, q, h, n)


def _jax_pallas_ssd(x, dt_a, b, c):
    """The JAX kernel, interpreted, on the same values (B and C broadcast)."""
    j = [jnp.asarray(t.float().contiguous().numpy(), jnp.bfloat16)
         for t in (x, b, c)]
    out = jops.ssd_chunk(j[0], jnp.asarray(dt_a.numpy()), j[1], j[2],
                         force="pallas_interpret", block_h=x.shape[2])
    return tuple(torch.from_numpy(np.array(o, np.float32)) for o in out)


def _k7_bars(got, want):
    """chip_smoke.py's bf16 bars: y element-wise 2^-7·|ref| + 1e-3·max|ref|
    and norm-wise 2^-7; state and decay 1e-3 of the largest value."""
    ok, _, crit = SMOKE._close(torch, got[0], want[0].bfloat16(),
                               SMOKE.K7_FP32_RTOL, None)
    rel = [SMOKE.errors(g, w)[1] for g, w in zip(got[1:], want[1:])]
    return ok, crit, rel


def test_ssd_bf16_kernel_arithmetic_meets_the_card_bars():
    """The hi/lo emulation against ssd_chunk_ref and the JAX kernel."""
    ins = _k7_serving_inputs(21)
    got = _k7_bf16_emulation(*ins)
    assert got[0].dtype == torch.bfloat16
    for want in (ref.ssd_chunk_ref(*ins), _jax_pallas_ssd(*ins)):
        ok, crit, rel = _k7_bars(got, want)
        assert ok, crit
        assert max(rel) <= SMOKE.K7_BF16_STATE_RTOL, rel


def test_ssd_bf16_single_rounding_misses_the_state_bar():
    """Why the kernel splits its weights: rounded once to bf16, w∘B puts
    the state past its 1e-3 bar (and the hi/lo pair does not)."""
    ins = _k7_serving_inputs(21)
    want = ref.ssd_chunk_ref(*ins)
    single = _k7_bars(_k7_bf16_emulation(*ins, split=False), want)[2]
    split = _k7_bars(_k7_bf16_emulation(*ins), want)[2]
    assert single[0] > SMOKE.K7_BF16_STATE_RTOL >= split[0], (single, split)


# ---- K7 at N <= 128 and K6 with Sq != Sk --------------------------------

# (bc, q, h, p, n, block_h): mamba2-2.7b's N = 128 at small Q, N = 96 and
# a ragged chunk
SSD_WIDE_SHAPES = [(2, 16, 4, 16, 128, 4), (1, 24, 2, 8, 96, 2),
                   (3, 8, 4, 8, 128, 2)]


@pytest.mark.parametrize("bc,q,h,p,n,bh", SSD_WIDE_SHAPES)
def test_ssd_chunk_plain_at_wide_states_matches_reference(bc, q, h, p, n, bh):
    """The plain version at N > 64 (the kernels take N <= 128) against the
    reference's ``ssd_chunk`` run as its jnp oracle and as its Pallas
    kernel interpreted; and with one B/C group broadcast (stride 0).  Sums
    of 128 products reach ~30, where fp32 order alone moves an element by
    ~1e-5: the bar is chip_smoke.py's, 1e-5 of each output's largest
    value."""
    def close(ours, theirs):
        for o, t in zip(ours, theirs):
            t = np.asarray(t, np.float32)
            d = np.abs(o.float().numpy() - t).max()
            assert d <= SMOKE.K7_FP32_RTOL * np.abs(t).max(), d

    arrs = _ssd_inputs(bc, q, h, p, n, seed=6)
    jarrs = [jnp.asarray(a) for a in arrs]
    got = ssd_chunk(*(torch.from_numpy(a) for a in arrs))
    assert tuple(got[1].shape) == (bc, h, p, n)
    close(got, jops.ssd_chunk(*jarrs, force="ref"))
    close(got, jops.ssd_chunk(*jarrs, force="pallas_interpret", block_h=bh))
    x, dt_a, b, c = arrs
    b1, c1 = b[:, :, :1], c[:, :, :1]
    got = ssd_chunk(torch.from_numpy(x), torch.from_numpy(dt_a),
                    torch.from_numpy(b1).expand(bc, q, h, n),
                    torch.from_numpy(c1).expand(bc, q, h, n))
    close(got, jops.ssd_chunk(
        jnp.asarray(x), jnp.asarray(dt_a),
        jnp.asarray(np.broadcast_to(b1, b.shape)),
        jnp.asarray(np.broadcast_to(c1, c.shape)), force="ref"))


def test_ssd_plan_at_n128_keeps_four_waves():
    """N > 64 holds one block an SM (165 KB of tiles), so the plan keeps
    four waves of the 132 SMs: at mamba2-2.7b's 16 chunks x 80 heads, 2
    heads a block (640 blocks; the fastest in chip_smoke.py's sweep); N <=
    64 keeps its three-in-four rule (test_ssd_plan_fills_the_card)."""
    from repro_torch.kernels.ssd_scan import SM_COUNT, ssd_min_blocks

    assert ssd_min_blocks(64) == SSD_MIN_BLOCKS == 3 * 2 * SM_COUNT // 4
    assert ssd_min_blocks(128) == 4 * SM_COUNT
    assert ssd_plan(16, 80, 128, True, 128) == 2
    assert ssd_plan(16, 80, 128, True, 64) == 4
    assert ssd_plan(4, 80, 128, True, 128) == 1
    assert ssd_plan(16, 80, 128, False, 128) == 1
    with pytest.raises(ValueError, match="state size 129"):
        ssd_plan(16, 80, 128, True, 129)


def _cross_qkv(b, h, kv, sq, sk, d, seed):
    """q (B, Sq, H, D), k, v (B, Sk, KV, D): the model's layout."""
    rng = np.random.default_rng(seed)
    return (_np(rng, (b, sq, h, d)), _np(rng, (b, sk, kv, d)),
            _np(rng, (b, sk, kv, d)))


@pytest.mark.parametrize("b,h,kv,sq,sk,d", [(1, 4, 4, 7, 20, 16),
                                            (2, 4, 2, 1, 33, 32),
                                            (1, 6, 3, 40, 9, 16),
                                            (1, 2, 2, 5, 1, 128)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_plain_cross_matches_reference_sdpa(b, h, kv, sq, sk,
                                                            d, dtype):
    """Sq != Sk, not causal (cross-attention; GQA too): the plain version
    against the reference model's ``_sdpa`` with an all-true mask."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _cross_qkv(b, h, kv, sq, sk, d, seed=7)
    mask = jnp.ones((1, 1, 1, sq, sk), dtype=bool)
    with jax.disable_jit():
        want = JL._sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)), mask)
    views = [torch.from_numpy(a).to(tdt).transpose(1, 2) for a in (q, k, v)]
    got = flash_attention(*views, False).transpose(1, 2)
    assert got.dtype == tdt and got.shape == (b, sq, h, d)
    _close(got, want, tol)
    torch.testing.assert_close(
        ops.flash_attention(*views, False, mode="ref").transpose(1, 2), got)


def test_flash_attention_refuses_causal_with_unequal_lengths():
    """The choice for causal attention with Sq != Sk (which the reference
    never asks for): refused on either device, the plain version and
    ``ops``' ref mode included, before anything is launched."""
    q = torch.zeros(1, 2, 8, 16)
    kv = torch.zeros(1, 2, 12, 16)
    ops.reset_launches()
    for call in (lambda: flash_attention(q, kv, kv, True),
                 lambda: ops.flash_attention(q, kv, kv, True, mode="ref"),
                 lambda: ref.flash_attention_ref(q, kv, kv, True)):
        with pytest.raises(ValueError, match="causal attention needs Sq == Sk"):
            call()
    assert ops.launch_counts()["flash_attention"] == 0
    assert flash_attention(q, kv, kv, False).shape == q.shape


def test_ssd_bf16_kernel_arithmetic_at_n128_meets_the_card_bars():
    """The hi/lo emulation of the bf16 kernel at N = 128 (mamba2-2.7b's
    state, one B/C group broadcast) against ssd_chunk_ref, at
    chip_smoke.py's bars."""
    bc, q, h, p, n = 2, 128, 4, 64, 128
    rng = np.random.default_rng(22)
    x = torch.from_numpy(_np(rng, (bc, q, h, p))).bfloat16()
    dt_a = torch.from_numpy(-np.abs(_np(rng, (bc, q, h))) * 0.3)
    b1, c1 = (torch.from_numpy(_np(rng, (bc, q, 1, n))).bfloat16()
              for _ in range(2))
    ins = (x, dt_a, b1.expand(bc, q, h, n), c1.expand(bc, q, h, n))
    ok, crit, rel = _k7_bars(_k7_bf16_emulation(*ins), ref.ssd_chunk_ref(*ins))
    assert ok, crit
    assert max(rel) <= SMOKE.K7_BF16_STATE_RTOL, rel


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _held(out, want, fp32_rtol, slack=None):
    ok, _, crit = SMOKE._close(torch, out, want, fp32_rtol, slack)
    assert ok, crit


@pytest.mark.gpu
@pytest.mark.parametrize("bc,q,h,p,n", [(16, 128, 80, 64, 128),
                                        (2, 100, 8, 64, 128),
                                        (3, 128, 4, 64, 96),
                                        (1, 64, 2, 30, 90)])
@pytest.mark.parametrize("shared_bc", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_at_wide_states_matches_plain_on_card(cuda, bc, q, h, p, n,
                                                        shared_bc, dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = 1 if shared_bc else h

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)
    x = rand(bc, q, h, p).to(dtype)
    dt_a = -rand(bc, q, h).abs() * 0.3
    b, c = (rand(bc, q, g, n).to(dtype).expand(bc, q, h, n) for _ in range(2))
    before = ops.launch_counts()["ssd_chunk"]
    out = ssd_chunk(x, dt_a, b, c)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_chunk"] == before + 1
    want = ref.ssd_chunk_ref(x, dt_a, b, c)
    _held(out[0], want[0], SMOKE.K7_FP32_RTOL)
    rtol = (SMOKE.K7_BF16_STATE_RTOL if dtype == torch.bfloat16
            else SMOKE.K7_FP32_RTOL)
    for o, w in zip(out[1:], want[1:]):
        assert SMOKE.errors(o, w)[1] <= rtol
    for a, a2 in zip(out, ssd_chunk(x, dt_a, b, c)):
        assert torch.equal(a, a2)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,sq,sk,d", [(1, 16, 16, 512, 1024, 64),
                                            (1, 16, 16, 1, 1024, 64),
                                            (1, 4, 4, 77, 203, 64),
                                            (2, 4, 4, 300, 100, 64),
                                            (1, 8, 2, 77, 203, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cross_matches_plain_on_card(cuda, b, h, kv, sq, sk,
                                                     d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(b, sq, h, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(b, sk, kv, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    before = ops.launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, False)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    _held(out, ref.flash_attention_ref(q, k, v, False), SMOKE.K6_FP32_RTOL,
          lambda: SMOKE.BF16_ULP * ref.flash_attention_ref(
              q.float(), k.float(), v.float().abs(), False))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "seamless-m4t-large-v2",
                                  "qwen2-vl-72b"])
def test_new_family_kernel_path_matches_plain_path_on_card(cuda, arch):
    """fp32 smoke model on the card: the prefill through K6/K7 against the
    plain path, logits and caches within 1e-4; the launches of one
    prefill as chip_smoke.py counts them."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import vlm
    from repro_torch.models.api import get_model

    cfg = smoke_config(arch)
    model = get_model(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.inference_mode():
        params = model.init(gen, cuda)
        toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                             device=cuda)
        if cfg.family == "encdec":
            batch = {"enc_embeds": torch.randn(2, 50, cfg.d_model,
                                               generator=gen, device=cuda),
                     "dec_tokens": toks}
        elif cfg.family == "vlm":
            batch = {"embeds": torch.randn(2, 40, cfg.d_model, generator=gen,
                                           device=cuda),
                     "positions": vlm.make_image_positions(2, 2, 4, 5, cuda)}
        else:
            batch = {"tokens": toks}
        before = ops.launch_counts()
        lk, ck = model.prefill(params, batch, 48)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        lp, cp = model.prefill(params, batch, 48, mode="ref")
    per = SMOKE.launches_per_prefill(cfg)
    for name in ("flash_attention", "ssd_chunk"):
        assert after[name] - before[name] == per[name]
    for key in ck:
        if key != "len":
            assert SMOKE.errors(ck[key], cp[key])[1] <= 1e-4, key
    assert SMOKE.errors(lk, lp)[1] <= 1e-4


@pytest.mark.parametrize("window", [1, 5, 64, 129, 1000])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chip_smoke_window_slices_equal_the_plain_version(window, h, kv,
                                                          dtype):
    """chip_smoke.py's phase 20 holds K6 at a length whose whole score
    matrix does not fit by query-row slices that read only their window's
    keys; the slices put together are the plain version bit for bit."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, h, 300, 16, generator=g).to(dtype)
    k, v = (torch.randn(1, kv, 300, 16, generator=g).to(dtype)
            for _ in range(2))
    rows = torch.cat([SMOKE.windowed_rows_ref(torch, q, k, v, q0,
                                              min(300, q0 + 64), window)
                      for q0 in range(0, 300, 64)], dim=2)
    assert torch.equal(rows, ref.flash_attention_ref(q, k, v, True, window))
