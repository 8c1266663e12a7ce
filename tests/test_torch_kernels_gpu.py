"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every case is marked ``gpu`` and skips where there is no CUDA
device; the file imports no jax, so it runs on a machine without it:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: 1e-4 relative to the largest output for the GEMMs (fp32 sums
of up to 4000 terms taken in another order than cuBLAS's), 1e-5 for
nll/lse, and for dlogits chip_smoke.py's element-wise bar
(``dlogits_error``: 1e-5 of each element's size in fp32, one bf16 ulp in
bf16, plus 1e-6 of its row's largest); the LM prefill kernels' are stated
with their tests below.
"""


import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.fcnn_layer import (
    fcnn_layer,
    fcnn_layer_dgrad,
    fcnn_layer_wgrad,
)
from repro_torch.kernels.softmax_xent import (
    softmax_xent_dlogits,
    softmax_xent_fwd,
)

ACTS = ["sigmoid", "relu", "tanh", "none"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dev, scale=1.0):
    return torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32)).to(dev)


def _assert_rel(out, want, rtol):
    err = (out.double() - want.double()).abs().max().item()
    assert err <= rtol * max(want.double().abs().max().item(), 1e-30), err


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 784, 1000), (64, 500, 10),
                                   (1, 784, 10), (128, 1024, 4000)])
@pytest.mark.parametrize("act", ACTS)
def test_fcnn_kernels_match_plain_on_card(cuda, m, k, n, act):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, (m, k), cuda), _rand(rng, (k, n), cuda, k ** -0.5)
    b, dy = _rand(rng, (n,), cuda, 0.1), _rand(rng, (m, n), cuda, 0.01)
    before = ops.launch_counts()
    y = fcnn_layer(x, w, b, act)
    dx = fcnn_layer_dgrad(dy, y, w, act)
    dw, db = fcnn_layer_wgrad(x, dy, y, act)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("fcnn_layer", "fcnn_layer_dgrad", "fcnn_layer_wgrad"):
        assert after[name] == before[name] + 1
    _assert_rel(y, ref.fcnn_layer_ref(x, w, b, act), 1e-4)
    _assert_rel(dx, ref.fcnn_layer_dgrad_ref(dy, y, w, act), 1e-4)
    dw_r, db_r = ref.fcnn_layer_wgrad_ref(x, dy, y, act)
    _assert_rel(dw, dw_r, 1e-4)
    _assert_rel(db, db_r, 1e-4)


# K2 splits its contraction over the blocks of a cluster (dgrad_plan picks
# the split and slice width; the extension takes any split of 1, 2, 4, 8
# and slices of 16 or 32): N = 1000 is 63 slices of 16, not divisible by
# 8; N = 10 is one slice, shorter than any split; M = 1 is one ragged row.
@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,split,slice_", [
    (64, 1000, 1000, 8, 16), (64, 1000, 1000, 2, 32), (64, 500, 10, 8, 16),
    (1, 784, 10, 4, 32), (1, 784, 1000, 8, 16), (64, 1000, 500, None, None),
    (1, 784, 1000, None, None)])
@pytest.mark.parametrize("act", ACTS)
def test_fcnn_dgrad_split_edges_on_card(cuda, m, k, n, split, slice_, act):
    from repro_torch.kernels import _build
    from repro_torch.kernels.fcnn_layer import act_code, dgrad_plan

    rng = np.random.default_rng(3)
    w = _rand(rng, (k, n), cuda, k ** -0.5)
    y = ref.apply_activation(_rand(rng, (m, n), cuda), act)
    dy = _rand(rng, (m, n), cuda, 0.01)
    if split is None:
        split, slice_ = dgrad_plan(m, k, n)
        before = ops.launch_counts()["fcnn_layer_dgrad"]
        dx = fcnn_layer_dgrad(dy, y, w, act)
        assert ops.launch_counts()["fcnn_layer_dgrad"] == before + 1
    else:
        dx = torch.empty(m, k, device=cuda)
        _build.extension().fcnn_dgrad(dy, y, w, dx, act_code(act), split,
                                      slice_)
    torch.cuda.synchronize()
    assert split > 1
    _assert_rel(dx, ref.fcnn_layer_dgrad_ref(dy, y, w, act), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 1000, 500), (128, 1000, 4000)])
def test_fcnn_dgrad_is_deterministic_on_card(cuda, m, k, n):
    """The split partials are summed in rank order: repeated calls give
    bit-identical dX."""
    rng = np.random.default_rng(4)
    w = _rand(rng, (k, n), cuda, k ** -0.5)
    y = torch.sigmoid(_rand(rng, (m, n), cuda))
    dy = _rand(rng, (m, n), cuda, 0.01)
    first = fcnn_layer_dgrad(dy, y, w, "sigmoid")
    for _ in range(3):
        assert torch.equal(fcnn_layer_dgrad(dy, y, w, "sigmoid"), first)


# K1 splits its contraction K over the blocks of a cluster (fwd_plan picks
# the split and slice width; the extension takes splits of 1, 2, 4, 8 and
# the non-portable 16, slices of 16 or 32).  The bias and activation must
# run once, on the complete sum: every activation at every split.  K = 784
# is 49 slices of 16, not divisible by 8; K = 50 and 783 take 4-byte copies
# of x, N = 10 and 37 of w; M = 1 and 13 are ragged rows.
@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,split,slice_", [
    (64, 784, 1000, 1, 16), (64, 784, 1000, 2, 32), (64, 784, 10, 4, 16),
    (1, 784, 10, 8, 32), (64, 784, 1000, 8, 16), (13, 50, 10, 2, 16),
    (1, 783, 37, 8, 32), (128, 4000, 10, 16, 32), (64, 500, 10, 16, 16),
    (64, 1000, 500, None, None), (128, 4000, 1000, None, None)])
@pytest.mark.parametrize("act", ACTS)
def test_fcnn_fwd_split_edges_on_card(cuda, m, k, n, split, slice_, act):
    from repro_torch.kernels import _build
    from repro_torch.kernels.fcnn_layer import act_code, fwd_plan

    rng = np.random.default_rng(6)
    x, w = _rand(rng, (m, k), cuda), _rand(rng, (k, n), cuda, k ** -0.5)
    b = _rand(rng, (n,), cuda, 0.5)
    if split is None:
        assert fwd_plan(m, k, n)[0] > 1
        before = ops.launch_counts()["fcnn_layer"]
        out = fcnn_layer(x, w, b, act)
        assert ops.launch_counts()["fcnn_layer"] == before + 1
    else:
        out = torch.empty(m, n, device=cuda)
        _build.extension().fcnn_fwd(x, w, b, out, act_code(act), split,
                                    slice_)
    torch.cuda.synchronize()
    _assert_rel(out, ref.fcnn_layer_ref(x, w, b, act), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 1000, 500), (128, 4000, 1000)])
def test_fcnn_fwd_is_deterministic_on_card(cuda, m, k, n):
    """The split partials are summed in rank order: repeated calls give
    bit-identical outputs."""
    from repro_torch.kernels.fcnn_layer import fwd_plan

    assert fwd_plan(m, k, n)[0] > 1
    rng = np.random.default_rng(7)
    x, w = _rand(rng, (m, k), cuda), _rand(rng, (k, n), cuda, k ** -0.5)
    b = _rand(rng, (n,), cuda, 0.1)
    first = fcnn_layer(x, w, b, "sigmoid")
    for _ in range(3):
        assert torch.equal(fcnn_layer(x, w, b, "sigmoid"), first)


# The column chunks of the period programs on an 8-device ring
# (repro_torch.exec): NN1 ORRM widths 125/125/5 and NN2 375/98/125/125/5
# at batch 64, NN5 500/125/500/5 at batch 128.  Widths 125, 375, 98 and 5
# take K1's 4-byte copies of w; K2's contraction is 5 at the output layer,
# under one 16-wide slice.
CHUNK_SHAPES = [(64, 784, 125, "sigmoid"), (64, 1000, 125, "sigmoid"),
                (64, 500, 5, "none"), (64, 784, 375, "sigmoid"),
                (64, 1500, 98, "sigmoid"), (128, 1024, 500, "sigmoid"),
                (128, 4000, 125, "sigmoid"), (128, 1000, 500, "sigmoid"),
                (128, 4000, 5, "none")]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,act", CHUNK_SHAPES)
def test_fcnn_kernels_at_program_chunk_shapes_on_card(cuda, m, k, n, act):
    rng = np.random.default_rng(8)
    x, w = _rand(rng, (m, k), cuda), _rand(rng, (k, n), cuda, k ** -0.5)
    b, dy = _rand(rng, (n,), cuda, 0.1), _rand(rng, (m, n), cuda, 0.01)
    y = fcnn_layer(x, w, b, act)
    dx = fcnn_layer_dgrad(dy, y, w, act)
    dw, db = fcnn_layer_wgrad(x, dy, y, act)
    torch.cuda.synchronize()
    _assert_rel(y, ref.fcnn_layer_ref(x, w, b, act), 1e-4)
    _assert_rel(dx, ref.fcnn_layer_dgrad_ref(dy, y, w, act), 1e-4)
    dw_r, db_r = ref.fcnn_layer_wgrad_ref(x, dy, y, act)
    _assert_rel(dw, dw_r, 1e-4)
    _assert_rel(db, db_r, 1e-4)
    assert torch.equal(fcnn_layer(x, w, b, act), y)
    assert torch.equal(fcnn_layer_dgrad(dy, y, w, act), dx)


@pytest.mark.gpu
@pytest.mark.parametrize("split,slice_", [(3, 32), (32, 32), (2, 8), (0, 16)])
def test_fcnn_fwd_refuses_bad_plans_on_card(cuda, split, slice_):
    from repro_torch.kernels import _build

    x, w = torch.ones(4, 8, device=cuda), torch.ones(8, 10, device=cuda)
    b, out = torch.zeros(10, device=cuda), torch.empty(4, 10, device=cuda)
    with pytest.raises(RuntimeError, match="fcnn_layer launch failed"):
        _build.extension().fcnn_fwd(x, w, b, out, 1, split, slice_)


# K3 walks the batch in 32-row slices through a ring of cp.async stages
# (M = 300: 10 slices, the last ragged); M = 1 is one zero-filled slice.
# N = 10 takes 4-byte copies of dY and Y, K = 50 of x.  Every dW tile
# (64 x 64 with 4 x 8 outputs a thread, 128 x 64 and 128 x 128 with 8 x 8)
# at every shape, whatever wgrad_plan picks.
@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [
    (1, 784, 10), (1, 784, 1000), (64, 784, 10), (64, 784, 1000),
    (128, 500, 10), (128, 500, 1000), (300, 784, 10), (300, 50, 1000)])
@pytest.mark.parametrize("act", ACTS)
def test_fcnn_wgrad_batches_on_card(cuda, m, k, n, act):
    from repro_torch.kernels import _build
    from repro_torch.kernels.fcnn_layer import WGRAD_TILES, act_code

    rng = np.random.default_rng(8)
    x = _rand(rng, (m, k), cuda)
    y = ref.apply_activation(_rand(rng, (m, n), cuda), act)
    dy = _rand(rng, (m, n), cuda, 0.01)
    before = ops.launch_counts()["fcnn_layer_wgrad"]
    dw, db = fcnn_layer_wgrad(x, dy, y, act)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fcnn_layer_wgrad"] == before + 1
    dw_r, db_r = ref.fcnn_layer_wgrad_ref(x, dy, y, act)
    _assert_rel(dw, dw_r, 1e-4)
    _assert_rel(db, db_r, 1e-4)
    again = fcnn_layer_wgrad(x, dy, y, act)
    assert torch.equal(again[0], dw) and torch.equal(again[1], db)
    for rows, cols in WGRAD_TILES:
        dw_t, db_t = torch.empty(k, n, device=cuda), torch.empty(n, device=cuda)
        _build.extension().fcnn_wgrad(x, dy, y, dw_t, db_t, act_code(act),
                                      rows, cols)
        torch.cuda.synchronize()
        _assert_rel(dw_t, dw_r, 1e-4)
        _assert_rel(db_t, db_r, 1e-4)


@pytest.mark.gpu
def test_fcnn_wgrad_refuses_bad_tiles_on_card(cuda):
    from repro_torch.kernels import _build

    x, dy = torch.ones(4, 8, device=cuda), torch.ones(4, 10, device=cuda)
    dw, db = torch.empty(8, 10, device=cuda), torch.empty(10, device=cuda)
    with pytest.raises(RuntimeError, match="fcnn_layer_wgrad launch failed"):
        _build.extension().fcnn_wgrad(x, dy, dy, dw, db, 1, 64, 128)


XENT_SHAPES = [(1, 10), (64, 10), (128, 10), (37, 300), (1000, 10),
               (3000, 33)]


def _xent_inputs(rng, b, c, dtype, dev):
    logits = _rand(rng, (b, c), dev, 3.0).to(dtype)
    labels = torch.from_numpy(
        rng.integers(0, c, size=b).astype(np.int32)).to(dev)
    return logits, labels


_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)


def _assert_xent(out, want):
    for o, w in zip(out, want):
        assert o.dtype == w.dtype and o.shape == w.shape
        torch.testing.assert_close(o.float(), w.float(), rtol=0, atol=1e-5)


def _assert_dlogits(out, want):
    for o, w in zip(out, want):
        assert o.dtype == w.dtype and o.shape == w.shape
        assert SMOKE.dlogits_error(o, w) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c", XENT_SHAPES)
def test_softmax_xent_kernels_match_plain_on_card(cuda, b, c, dtype):
    """K4's (nll, lse, mean) within 1e-5 and K5 in both of its forms,
    per-row scale (contiguous and stride 0) and the loss cotangent g,
    within its element-wise bar."""
    rng = np.random.default_rng(5)
    logits, labels = _xent_inputs(rng, b, c, dtype, cuda)
    before = ops.launch_counts()
    out = softmax_xent_fwd(logits, labels)
    lse = out[1]
    g = torch.tensor(0.7, device=cuda)
    scale = torch.full((b,), 0.7 / b, device=cuda)
    dls = [softmax_xent_dlogits(logits, labels, lse, scale),
           softmax_xent_dlogits(logits, labels, lse, scale[:1].expand(b)),
           softmax_xent_dlogits(logits, labels, lse, g=g)]
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["softmax_xent_fwd"] - before["softmax_xent_fwd"] == 1
    assert after["softmax_xent_dlogits"] - before["softmax_xent_dlogits"] == 3
    _assert_xent(out, ref.softmax_xent_fwd_ref(logits, labels))
    _assert_dlogits(dls, [ref.softmax_xent_dlogits_ref(logits, labels, lse,
                                                       scale)] * 2
                    + [ref.softmax_xent_dlogits_ref(logits, labels, lse, g=g)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c", XENT_SHAPES)
def test_softmax_xent_every_block_shape_on_card(cuda, b, c, dtype):
    """K4 at every shape (one block, a thread a row, where C <= 16 and
    B <= 256; else one block of warps, a warp a row) and K5; the mean of
    two runs is bit-identical."""
    rng = np.random.default_rng(6)
    logits, labels = _xent_inputs(rng, b, c, dtype, cuda)
    want = ref.softmax_xent_fwd_ref(logits, labels)
    g = torch.tensor(0.3, device=cuda)
    runs = [softmax_xent_fwd(logits, labels) for _ in range(2)]
    dx = softmax_xent_dlogits(logits, labels, want[1], g=g)
    torch.cuda.synchronize()
    _assert_xent(runs[0], want)
    assert torch.equal(runs[0][2], runs[1][2])
    _assert_dlogits([dx], [ref.softmax_xent_dlogits_ref(logits, labels,
                                                        want[1], g=g)])


@pytest.mark.gpu
@pytest.mark.parametrize("b,c", [(64, 10), (37, 300), (1000, 10)])
def test_softmax_xent_reads_fresh_inputs_in_a_graph(cuda, b, c):
    """A CUDA graph of [a kernel that writes the logits -> K4] and [a
    kernel that writes g -> K5]: every replay reads the values just
    written, g included, which K5 reads on the card and not at capture."""
    rng = np.random.default_rng(8)
    src, labels = _xent_inputs(rng, b, c, torch.float32, cuda)
    logits = torch.empty_like(src)
    g_src = torch.tensor(1.0, device=cuda)
    g = torch.empty((), device=cuda)
    factor = torch.tensor(2.0, device=cuda)

    def step():
        torch.mul(src, factor, out=logits)
        out = softmax_xent_fwd(logits, labels)
        torch.mul(g_src, factor, out=g)
        return out, softmax_xent_dlogits(logits, labels, out[1], g=g)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, dl = step()
    for f in (0.5, -1.5, 3.0, 0.25):
        factor.fill_(f)
        graph.replay()
        torch.cuda.synchronize()
        x = src * f
        want = ref.softmax_xent_fwd_ref(x, labels)
        _assert_xent(out, want)
        _assert_dlogits([dl], [ref.softmax_xent_dlogits_ref(
            x, labels, want[1], g=g_src * f)])


@pytest.mark.gpu
def test_launch_floor_kernel_runs_on_card(cuda):
    from repro_torch.kernels import _build

    _build.extension().launch_floor()
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_fused_ops_launch_the_kernels_on_card(cuda):
    """A CUDA tensor goes through the kernels, never the plain versions,
    and the gradients agree with autograd of the plain versions."""
    rng = np.random.default_rng(2)
    x = _rand(rng, (64, 784), cuda)
    w = _rand(rng, (784, 10), cuda, 784 ** -0.5).requires_grad_(True)
    b = _rand(rng, (10,), cuda, 0.1).requires_grad_(True)
    y = torch.from_numpy(rng.integers(0, 10, size=64).astype(np.int32)).to(cuda)
    ops.reset_launches()
    loss = ops.softmax_xent(ops.fcnn_layer(x, w, b, "none", mode="cuda"), y,
                            mode="cuda")
    gw, gb = torch.autograd.grad(loss, [w, b])
    counts = ops.launch_counts()
    assert counts == {"fcnn_layer": 1, "fcnn_layer_dgrad": 0,
                      "fcnn_layer_wgrad": 1, "softmax_xent_fwd": 1,
                      "softmax_xent_dlogits": 1, "flash_attention": 0,
                      "ssd_chunk": 0}
    loss_r = ops.softmax_xent(ops.fcnn_layer(x, w, b, "none", mode="ref"), y,
                              mode="ref")
    gw_r, gb_r = torch.autograd.grad(loss_r, [w, b])
    torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=1e-5)
    _assert_rel(gw, gw_r, 1e-4)
    _assert_rel(gb, gb_r, 1e-4)


# ---- LM prefill kernels: flash attention (K6), SSD chunk (K7) ----------
# Tolerances: fp32 2e-5 (K6) and 1e-5 (K7) of the largest output.  A bf16
# output is held element-wise to 2^-7 |plain| (one bf16 ulp: both sides
# round their fp32 result) plus ``slack``, and as a whole to
# ||out − plain||_2 <= 2^-7 ||plain||_2.  K6's slack is 2^-7 (softmax @ |v|):
# the kernel rounds exp(s − running max) to bf16 where the plain version
# rounds the normalised softmax, so each probability may differ by one
# rounding of each.  K7's is 1e-3 of the largest output (fp32 sums in
# another order).  K7's fp32 state and decay from bf16 inputs: 1e-3 of the
# largest value.

LM_DTYPES = [torch.float32, torch.bfloat16]
BF16_ULP = 2.0 ** -7


def _assert_lm(out, want, fp32_rtol, slack=None):
    if out.dtype == torch.bfloat16:
        o, w = out.double(), want.double()
        if slack is None:
            slack = 1e-3 * w.abs().max()
        assert bool(((o - w).abs() <= BF16_ULP * w.abs() + slack).all())
        assert (o - w).norm() <= BF16_ULP * w.norm()
    else:
        _assert_rel(out, want, fp32_rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,d", [(1, 32, 128, 64), (1, 2, 100, 32),
                                     (2, 4, 300, 128), (1, 3, 8, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_flash_attention_matches_plain_on_card(cuda, b, h, s, d, causal,
                                               dtype):
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(11)
    # the model's layout: (B, S, H, D) seen as (B, H, S, D)
    q, k, v = (_rand(rng, (b, s, h, d), cuda).to(dtype).transpose(1, 2)
               for _ in range(3))
    before = ops.launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    mean_abs_v = ref.flash_attention_ref(q.float(), k.float(),
                                         v.float().abs(), causal)
    _assert_lm(out, ref.flash_attention_ref(q, k, v, causal), 2e-5,
               BF16_ULP * mean_abs_v.double())


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1024, 2048])
def test_flash_attention_bf16_serving_shapes_on_card(cuda, s):
    """The tensor-core bf16 kernel at the Zamba2 prefill shapes, causal."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(13)
    q, k, v = (_rand(rng, (1, s, 32, 64), cuda).to(torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    out = flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    mean_abs_v = ref.flash_attention_ref(q.float(), k.float(),
                                         v.float().abs(), True)
    _assert_lm(out, ref.flash_attention_ref(q, k, v, True), 2e-5,
               BF16_ULP * mean_abs_v.double())


@pytest.mark.gpu
def test_flash_attention_refuses_misaligned_bf16_on_card(cuda):
    """A bf16 view whose row stride (66 bytes) TMA cannot take raises,
    and nothing is launched."""
    from repro_torch.kernels.flash_attention import flash_attention

    t = torch.zeros(1, 2, 8, 33, dtype=torch.bfloat16, device=cuda)[..., :32]
    before = ops.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(t, t, t)
    assert ops.launch_counts()["flash_attention"] == before


def _ssd_inputs_on_card(rng, dev, bc, q, h, p, n, dtype, shared_bc):
    g = 1 if shared_bc else h
    x = _rand(rng, (bc, q, h, p), dev).to(dtype)
    dt_a = -_rand(rng, (bc, q, h), dev).abs() * 0.3
    b = _rand(rng, (bc, q, g, n), dev).to(dtype).expand(bc, q, h, n)
    c = _rand(rng, (bc, q, g, n), dev).to(dtype).expand(bc, q, h, n)
    return x, dt_a, b, c


@pytest.mark.gpu
@pytest.mark.parametrize("bc,q,h,p,n", [(16, 128, 64, 64, 64),
                                        (2, 16, 8, 8, 4), (1, 32, 4, 16, 8),
                                        (3, 8, 16, 8, 16)])
@pytest.mark.parametrize("shared_bc", [True, False])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_ssd_chunk_matches_plain_on_card(cuda, bc, q, h, p, n, shared_bc,
                                         dtype):
    from repro_torch.kernels.ssd_scan import ssd_chunk

    rng = np.random.default_rng(12)
    x, dt_a, b, c = _ssd_inputs_on_card(rng, cuda, bc, q, h, p, n, dtype,
                                        shared_bc)
    before = ops.launch_counts()["ssd_chunk"]
    y, st, dec = ssd_chunk(x, dt_a, b, c)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_chunk"] == before + 1
    y_r, st_r, dec_r = ref.ssd_chunk_ref(x, dt_a, b, c)
    _assert_lm(y, y_r, 1e-5)
    state_rtol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    _assert_rel(st, st_r, state_rtol)
    _assert_rel(dec, dec_r, state_rtol)


# bf16 K7's blocks walk `heads` consecutive heads of a chunk (ssd_plan picks
# 1, 2 or 4 at the serving shapes; the kernel takes any divisor of H up to
# 8), staging a stride-0 B/C once for all of them.
@pytest.mark.gpu
@pytest.mark.parametrize("bc", [1, 4, 8, 16])
@pytest.mark.parametrize("heads", [1, 2, 4, 8])
@pytest.mark.parametrize("shared_bc", [True, False])
def test_ssd_chunk_bf16_every_heads_per_block_on_card(cuda, bc, heads,
                                                      shared_bc):
    from repro_torch.kernels import _build

    rng = np.random.default_rng(14)
    x, dt_a, b, c = _ssd_inputs_on_card(rng, cuda, bc, 128, 64, 64, 64,
                                        torch.bfloat16, shared_bc)

    def run():
        y = torch.empty_like(x)
        st = torch.empty((bc, 64, 64, 64), device=cuda)
        dec = torch.empty((bc, 128, 64), device=cuda)
        _build.extension().ssd_chunk(x, dt_a, b, c, y, st, dec, heads)
        return y, st, dec

    y, st, dec = run()
    torch.cuda.synchronize()
    y_r, st_r, dec_r = ref.ssd_chunk_ref(x, dt_a, b, c)
    _assert_lm(y, y_r, 1e-5)
    _assert_rel(st, st_r, 1e-3)
    _assert_rel(dec, dec_r, 1e-3)
    for a, a2 in zip((y, st, dec), run()):
        assert torch.equal(a, a2)


@pytest.mark.gpu
@pytest.mark.parametrize("bc", [1, 16])
def test_ssd_chunk_bf16_repeats_are_bit_identical_on_card(cuda, bc):
    """Through the wrapper (its plan's heads per block), two calls on the
    same inputs give the same bits: no atomics, sums in a fixed order."""
    from repro_torch.kernels.ssd_scan import ssd_chunk

    rng = np.random.default_rng(15)
    ins = _ssd_inputs_on_card(rng, cuda, bc, 128, 64, 64, 64, torch.bfloat16,
                              True)
    first = ssd_chunk(*ins)
    for a, a2 in zip(first, ssd_chunk(*ins)):
        assert torch.equal(a, a2)


@pytest.mark.gpu
def test_zamba2_prefill_goes_through_the_kernels_on_card(cuda):
    """The smoke model's prefill on the card: 2 flash and 5 SSD launches,
    logits and cache within 1e-4 of the plain path (fp32)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.api import get_model

    cfg = smoke_config("zamba2-1.2b")
    model = get_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda)
    ops.reset_launches()
    logits, cache = model.prefill(params, {"tokens": toks}, 40)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["ssd_chunk"]) == (2, 5)
    logits_r, cache_r = model.prefill(params, {"tokens": toks}, 40,
                                      mode="ref")
    _assert_rel(logits, logits_r, 1e-4)
    for key in ("ssm", "conv", "k", "v"):
        _assert_rel(cache[key], cache_r[key], 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 16, 64), (1, 300, 2048)])
def test_swiglu_products_stay_fp32_on_card(cuda, shape):
    """``layers.matmul_fp32`` on bf16 operands returns fp32, within fp32
    summation order (1e-5 of the largest) of the fp32 product of the
    upcast operands, the arithmetic the CPU path runs; the MLP rounds only
    silu(g)·u and its output."""
    from repro_torch.models import layers as L

    rng = np.random.default_rng(9)
    d, f = shape[-1], 4 * shape[-1]
    x = _rand(rng, shape, cuda).to(torch.bfloat16)
    p = {k: _rand(rng, s, cuda, s[0] ** -0.5).to(torch.bfloat16)
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                      ("w_down", (f, d)))}
    g = L.matmul_fp32(x, p["w_gate"])
    assert g.dtype == torch.float32 and g.shape == (*shape[:-1], f)
    _assert_rel(g, x.float() @ p["w_gate"].float(), 1e-5)
    h = (torch.nn.functional.silu(x.float() @ p["w_gate"].float())
         * (x.float() @ p["w_up"].float())).to(torch.bfloat16)
    out = L.mlp(p, x)
    assert out.dtype == torch.bfloat16
    _assert_rel(out, torch.matmul(h, p["w_down"]), 2.0 ** -7)
