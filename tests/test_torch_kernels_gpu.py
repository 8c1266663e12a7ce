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
from repro_torch.kernels.ssd_scan import SSD_BWD_HEADS
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
                      "flash_attention_bwd": 0, "ssd_chunk": 0,
                      "ssd_chunk_bwd": 0}
    loss_r = ops.softmax_xent(ops.fcnn_layer(x, w, b, "none", mode="ref"), y,
                              mode="ref")
    gw_r, gb_r = torch.autograd.grad(loss_r, [w, b])
    torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=1e-5)
    _assert_rel(gw, gw_r, 1e-4)
    _assert_rel(gb, gb_r, 1e-4)


# ---- K1-K3 in bf16 and mixed: chip_smoke.py phase 23's cases ----------
# (x dtype, w and b dtype); dy and y take x's.  Bars: chip_smoke's
# gemm_close (a bf16 output element-wise within 2^-7·|plain| + 1e-4 of the
# largest and norm-wise within 2^-7; an fp32 one within 1e-4 of the
# largest).  NN1's and NN5's layers and the ragged shapes: bf16 rows of
# 500 and 10 elements (not 16-byte multiples) take 4-byte pairs, of 13 and
# 5 (odd) guarded 2-byte loads.

BF16_CASES = {"a": (torch.bfloat16, torch.bfloat16),
              "b": (torch.float32, torch.bfloat16),
              "d": (torch.bfloat16, torch.float32)}
BF16_SHAPES = [(64, 784, 1000), (64, 1000, 500), (64, 500, 10),
               (128, 1024, 4000), (128, 4000, 1000), (128, 1000, 4000),
               (128, 4000, 10), (7, 13, 5), (3, 20, 10), (32, 500, 10),
               (100, 64, 64)]


def _bf16_layer(rng, m, k, n, case, act, dev):
    xd, wd = BF16_CASES[case]
    x = _rand(rng, (m, k), dev).to(xd)
    w = _rand(rng, (k, n), dev, k ** -0.5).to(wd)
    b = _rand(rng, (n,), dev, 0.1).to(wd)
    dy = _rand(rng, (m, n), dev, 0.01).to(xd)
    return x, w, b, dy, ref.fcnn_layer_ref(x, w, b, act)


def _assert_gemm(out, want):
    ok, err, note = SMOKE.gemm_close(torch, out, want)
    assert ok, (err, note)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", BF16_SHAPES)
@pytest.mark.parametrize("case", sorted(BF16_CASES))
@pytest.mark.parametrize("act", ACTS)
def test_fcnn_kernels_bf16_match_plain_on_card(cuda, m, k, n, case, act):
    rng = np.random.default_rng(11)
    x, w, b, dy, y = _bf16_layer(rng, m, k, n, case, act, cuda)
    before = ops.launch_counts()
    out = (fcnn_layer(x, w, b, act), fcnn_layer_dgrad(dy, y, w, act),
           *fcnn_layer_wgrad(x, dy, y, act))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("fcnn_layer", "fcnn_layer_dgrad", "fcnn_layer_wgrad"):
        assert after[name] == before[name] + 1
    want = (ref.fcnn_layer_ref(x, w, b, act),
            ref.fcnn_layer_dgrad_ref(dy, y, w, act),
            *ref.fcnn_layer_wgrad_ref(x, dy, y, act))
    assert [o.dtype for o in out] == [x.dtype, dy.dtype, x.dtype, dy.dtype]
    for o, r in zip(out, want):
        _assert_gemm(o, r)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 784, 1000), (64, 1000, 500),
                                   (64, 500, 10), (1, 783, 37),
                                   (13, 50, 10), (128, 4000, 10)])
@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_fcnn_bf16_every_plan_on_card(cuda, m, k, n, case):
    """Every (split, slice) of K1 and K2 and every dW tile of K3, as phase
    3 sweeps them in fp32, in bf16 and mixed."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fcnn_layer import WGRAD_TILES, act_code

    rng = np.random.default_rng(12)
    x, w, b, dy, y = _bf16_layer(rng, m, k, n, case, "sigmoid", cuda)
    ext, act = _build.extension(), act_code("sigmoid")
    y_r = ref.fcnn_layer_ref(x, w, b, "sigmoid")
    dx_r = ref.fcnn_layer_dgrad_ref(dy, y, w, "sigmoid")
    dw_r, db_r = ref.fcnn_layer_wgrad_ref(x, dy, y, "sigmoid")
    for split in (1, 2, 4, 8, 16):
        for slice_ in (16, 32):
            out = torch.empty(m, n, device=cuda, dtype=x.dtype)
            ext.fcnn_fwd(x, w, b, out, act, split, slice_)
            _assert_gemm(out, y_r)
            if split <= 8:
                dx = torch.empty(m, k, device=cuda, dtype=dy.dtype)
                ext.fcnn_dgrad(dy, y, w, dx, act, split, slice_)
                _assert_gemm(dx, dx_r)
    for rows, cols in WGRAD_TILES:
        dw = torch.empty(k, n, device=cuda, dtype=x.dtype)
        db = torch.empty(n, device=cuda, dtype=dy.dtype)
        ext.fcnn_wgrad(x, dy, y, dw, db, act, rows, cols)
        _assert_gemm(dw, dw_r)
        _assert_gemm(db, db_r)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 1000, 500), (128, 4000, 1000)])
@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_fcnn_fwd_dgrad_bf16_are_deterministic_on_card(cuda, m, k, n, case):
    """The split partials are summed in rank order and rounded once after:
    repeated bf16 and mixed calls give bit-identical outputs."""
    rng = np.random.default_rng(13)
    x, w, b, dy, y = _bf16_layer(rng, m, k, n, case, "sigmoid", cuda)
    first = fcnn_layer(x, w, b, "sigmoid")
    dx = fcnn_layer_dgrad(dy, y, w, "sigmoid")
    for _ in range(3):
        assert torch.equal(fcnn_layer(x, w, b, "sigmoid"), first)
        assert torch.equal(fcnn_layer_dgrad(dy, y, w, "sigmoid"), dx)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", BF16_SHAPES)
@pytest.mark.parametrize("case", ["a", "b"])
def test_fcnn_tc_every_plan_on_card(cuda, m, k, n, case):
    """K1's and K2's tensor-core kernels (bf16 w) at every width and split
    they are built for, held to the plain versions, each plan run twice
    bit-identical (the split partials summed in rank order)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fcnn_layer import (DGRAD_TC_WIDTHS,
                                                FWD_TC_WIDTHS, act_code)

    rng = np.random.default_rng(16)
    x, w, b, dy, y = _bf16_layer(rng, m, k, n, case, "tanh", cuda)
    ext, act = _build.extension(), act_code("tanh")
    y_r = ref.fcnn_layer_ref(x, w, b, "tanh")
    dx_r = ref.fcnn_layer_dgrad_ref(dy, y, w, "tanh")
    for split in (1, 2, 4, 8, 16):
        for width in FWD_TC_WIDTHS:
            outs = [torch.empty(m, n, device=cuda, dtype=x.dtype)
                    for _ in range(2)]
            for out in outs:
                ext.fcnn_fwd_tc(x, w, b, out, act, width, split)
            _assert_gemm(outs[0], y_r)
            assert torch.equal(*outs), (width, split)
        for width in DGRAD_TC_WIDTHS:
            dxs = [torch.empty(m, k, device=cuda, dtype=dy.dtype)
                   for _ in range(2)]
            for dx in dxs:
                ext.fcnn_dgrad_tc(dy, y, w, dx, act, width, split)
            _assert_gemm(dxs[0], dx_r)
            assert torch.equal(*dxs), (width, split)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", BF16_SHAPES)
@pytest.mark.parametrize("dy_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ACTS)
def test_fcnn_wgrad_tc_every_plan_on_card(cuda, m, k, n, dy_dtype, act):
    """K3's tensor-core kernel (bf16 x; dy and y in bf16 as in cases (a)
    and (d), or fp32) at every width and split it is built for, at NN1's,
    NN5's and the ragged shapes, held to the plain version (dW bf16, db in
    dy's dtype), each plan run twice bit-identical (the split partials and
    db summed in a fixed order); dW also held to ``rounded_once`` against
    the fp32 product rounded once, which the product of dZ rounded to bf16
    misses."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fcnn_layer import WGRAD_TC_WIDTHS, act_code

    rng = np.random.default_rng(18)
    x = _rand(rng, (m, k), cuda).to(torch.bfloat16)
    y = ref.apply_activation(_rand(rng, (m, n), cuda), act).to(dy_dtype)
    dy = _rand(rng, (m, n), cuda, 0.01).to(dy_dtype)
    ext, code = _build.extension(), act_code(act)
    dw_r, db_r = ref.fcnn_layer_wgrad_ref(x, dy, y, act)
    for width in WGRAD_TC_WIDTHS:
        for split in (1, 2, 4, 8, 16):
            outs = []
            for _ in range(2):
                dw = torch.empty(k, n, device=cuda, dtype=x.dtype)
                db = torch.empty(n, device=cuda, dtype=dy_dtype)
                ext.fcnn_wgrad_tc(x, dy, y, dw, db, code, width, split)
                outs.append((dw, db))
            _assert_gemm(outs[0][0], dw_r)
            _assert_gemm(outs[0][1], db_r)
            held, note = SMOKE.rounded_once(torch, outs[0][0], dw_r)
            assert held, (width, split, note)
            for a, b in zip(*outs):
                assert torch.equal(a, b), (width, split)
    if m * k * n >= 64 * 500 * 10 and (dy_dtype == torch.float32
                                       or act in ("sigmoid", "tanh")):
        # the control: dZ rounded to bf16 before the product misses the bar
        # (relu and none pass a bf16 dY through: dZ is bf16 already)
        dz = ref.act_deriv_from_output(y.float(), act) * dy.float()
        alone = (x.T @ dz.to(torch.bfloat16)).to(x.dtype)
        assert not SMOKE.rounded_once(torch, alone, dw_r)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 784, 1000), (64, 500, 10),
                                   (128, 4000, 1000)])
@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_fcnn_wgrad_picks_the_kernel_by_x_on_card(cuda, m, k, n, case):
    """bf16 x (cases (a), (d)) reaches K3's tensor-core kernel, at the
    output layer's width of 10 too, counted in ``launches`` and
    ``tc_launches``; fp32 x (case (b)) the CUDA-core one; repeats
    bit-identical."""
    rng = np.random.default_rng(19)
    x, w, b, dy, y = _bf16_layer(rng, m, k, n, case, "sigmoid", cuda)
    ops.reset_launches()
    dw, db = fcnn_layer_wgrad(x, dy, y, "sigmoid")
    torch.cuda.synchronize()
    tc = int(x.dtype == torch.bfloat16)
    assert fcnn_layer_wgrad.launches == 1
    assert fcnn_layer_wgrad.tc_launches == tc
    dw_r, db_r = ref.fcnn_layer_wgrad_ref(x, dy, y, "sigmoid")
    _assert_gemm(dw, dw_r)
    _assert_gemm(db, db_r)
    again = fcnn_layer_wgrad(x, dy, y, "sigmoid")
    assert torch.equal(again[0], dw) and torch.equal(again[1], db)


@pytest.mark.gpu
def test_fcnn_wgrad_tc_refuses_bad_plans_on_card(cuda):
    """A width K3's tensor-core kernel is not built for, a split that is
    not a power of two up to 16, or fp32 x is refused, never launched."""
    from repro_torch.kernels import _build

    ext = _build.extension()
    x = torch.randn(64, 100, device=cuda, dtype=torch.bfloat16)
    dy = torch.randn(64, 30, device=cuda, dtype=torch.bfloat16)
    dw = torch.empty(100, 30, device=cuda, dtype=torch.bfloat16)
    db = torch.empty(30, device=cuda, dtype=torch.bfloat16)
    for width, split in ((32, 1), (64, 3), (128, 32), (16, 0)):
        with pytest.raises(RuntimeError, match="launch failed"):
            ext.fcnn_wgrad_tc(x, dy, dy, dw, db, 1, width, split)
    with pytest.raises(RuntimeError, match="bfloat16"):
        ext.fcnn_wgrad_tc(x.float(), dy, dy, dw.float(), db, 1, 64, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_fcnn_wrappers_pick_the_kernel_by_w_on_card(cuda, case):
    """bf16 w (cases (a), (b)) reaches the tensor-core kernels, counted in
    ``launches`` and ``tc_launches``; fp32 w (case (d)) the CUDA-core
    ones."""
    rng = np.random.default_rng(17)
    x, w, b, dy, y = _bf16_layer(rng, 64, 1000, 500, case, "sigmoid", cuda)
    ops.reset_launches()
    fcnn_layer(x, w, b, "sigmoid")
    fcnn_layer_dgrad(dy, y, w, "sigmoid")
    torch.cuda.synchronize()
    tc = int(w.dtype == torch.bfloat16)
    assert fcnn_layer.launches == fcnn_layer_dgrad.launches == 1
    assert fcnn_layer.tc_launches == fcnn_layer_dgrad.tc_launches == tc


@pytest.mark.gpu
def test_fcnn_tc_refuses_bad_plans_on_card(cuda):
    """A width the tensor-core kernels are not built for, a split that is
    not a power of two up to 16, or fp32 w is refused, never launched."""
    from repro_torch.kernels import _build

    ext = _build.extension()
    x = torch.randn(64, 100, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(100, 30, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(30, device=cuda, dtype=torch.bfloat16)
    out = torch.empty(64, 30, device=cuda, dtype=torch.bfloat16)
    for width, split in ((32, 1), (64, 3), (64, 32), (16, 0)):
        with pytest.raises(RuntimeError, match="launch failed"):
            ext.fcnn_fwd_tc(x, w, b, out, 1, width, split)
    dx = torch.empty(64, 100, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):
        ext.fcnn_dgrad_tc(out, out, w, dx, 1, 16, 1)
    with pytest.raises(RuntimeError, match="bfloat16"):
        ext.fcnn_fwd_tc(x, w.float(), b.float(), out, 1, 64, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 784, 1000), (64, 500, 10),
                                   (7, 13, 5), (300, 50, 1000)])
@pytest.mark.parametrize("x_dtype,dy_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_fcnn_wgrad_mixed_groups_on_card(cuda, m, k, n, x_dtype, dy_dtype):
    """K3 with x and (dy, y) in different dtypes (off the FCNN's path, taken
    by the wrapper) at every dW tile: dW in x's dtype, db in dy's."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fcnn_layer import WGRAD_TILES, act_code

    rng = np.random.default_rng(15)
    x = _rand(rng, (m, k), cuda).to(x_dtype)
    y = torch.sigmoid(_rand(rng, (m, n), cuda)).to(dy_dtype)
    dy = _rand(rng, (m, n), cuda, 0.01).to(dy_dtype)
    dw_r, db_r = ref.fcnn_layer_wgrad_ref(x, dy, y, "sigmoid")
    dw, db = fcnn_layer_wgrad(x, dy, y, "sigmoid")
    _assert_gemm(dw, dw_r)
    _assert_gemm(db, db_r)
    for rows, cols in WGRAD_TILES:
        dw = torch.empty(k, n, device=cuda, dtype=x_dtype)
        db = torch.empty(n, device=cuda, dtype=dy_dtype)
        _build.extension().fcnn_wgrad(x, dy, y, dw, db, act_code("sigmoid"),
                                      rows, cols)
        _assert_gemm(dw, dw_r)
        _assert_gemm(db, db_r)


@pytest.mark.gpu
def test_fused_fcnn_mixed_launches_the_kernels_on_card(cuda):
    """Case (b), fp32 data into a bf16 layer: ``_FusedFCNN`` launches K1,
    K2 and K3 and never reaches a plain version; dX is fp32 (x's), dW and
    db bf16 (w's and b's, K3's fp32 dW rounded in the backward)."""
    rng = np.random.default_rng(14)
    x = _rand(rng, (64, 1000), cuda).requires_grad_(True)
    w = _rand(rng, (1000, 500), cuda, 1000 ** -0.5).to(
        torch.bfloat16).requires_grad_(True)
    b = _rand(rng, (500,), cuda, 0.1).to(torch.bfloat16).requires_grad_(True)
    with SMOKE.PlainSpy() as spy:
        ops.reset_launches()
        y = ops.fcnn_layer(x, w, b, "sigmoid", mode="cuda")
        gx, gw, gb = torch.autograd.grad(y.sum(), [x, w, b])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    assert not any(spy.calls.values()), spy.calls
    assert (counts["fcnn_layer"], counts["fcnn_layer_dgrad"],
            counts["fcnn_layer_wgrad"]) == (1, 1, 1)
    assert (y.dtype, gx.dtype, gw.dtype, gb.dtype) == (
        torch.float32, torch.float32, torch.bfloat16, torch.bfloat16)
    y_r = ops.fcnn_layer(x, w, b, "sigmoid", mode="ref")
    gx_r = torch.autograd.grad(y_r.sum(), [x])[0]
    dy = torch.ones_like(y_r)
    dw_r, db_r = ref.fcnn_layer_wgrad_ref(x.detach(), dy, y_r.detach(),
                                          "sigmoid")
    _assert_gemm(y, y_r)
    _assert_gemm(gx, gx_r)
    _assert_gemm(gw, dw_r.to(torch.bfloat16))
    _assert_gemm(gb, db_r.to(torch.bfloat16))


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
@pytest.mark.parametrize("b,h,kv,s,d", [(1, 4, 4, 300, 64), (1, 8, 2, 520, 128),
                                        (2, 4, 4, 129, 32), (1, 2, 1, 1, 64)])
@pytest.mark.parametrize("window", [1, 63, 64, 65, 127, 128, 129, 1000])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_flash_attention_window_matches_plain_on_card(cuda, b, h, kv, s, d,
                                                      window, dtype):
    """A causal sliding window (key k kept for query q where q - window <
    k <= q): windows inside one tile, at the 64- and 128-row
    tile edges, and past the sequence; window 1 returns v itself."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(17)
    q = _rand(rng, (b, s, h, d), cuda).to(dtype).transpose(1, 2)
    k, v = (_rand(rng, (b, s, kv, d), cuda).to(dtype).transpose(1, 2)
            for _ in range(2))
    before = ops.launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, True, window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    mean_abs_v = ref.flash_attention_ref(q.float(), k.float(),
                                         v.float().abs(), True, window)
    _assert_lm(out, ref.flash_attention_ref(q, k, v, True, window), 2e-5,
               BF16_ULP * mean_abs_v.double())
    if window == 1:
        want = v.repeat_interleave(h // kv, dim=1)
        assert torch.equal(out, want.to(out.dtype))


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


# K6's backward (flash_attention_bwd.cu) against its plain version
# (ref.flash_attention_bwd_ref) on the kernel's own o and lse, at phase 7's
# shapes and edges, bars chip_smoke.k6_bwd_close (fp32 1e-4 of each
# gradient's largest; bf16 per (b, head) slice one bf16 ulp of |plain| +
# 1e-3 of its largest, norm-wise 2^-7; each absolute part at least the fp32
# noise of one summed term, k6_bwd_noise) and, at the timed shapes,
# rounded_once for bf16 dV (chip_smoke.py says why not at the edges); two
# calls bit-identical; K6's o with the lse bit-identical to o without it
# and the lse within 1e-5·(1 + |plain|)
K6_BWD_TIMED = [shape for _, shape in SMOKE.K6_BWD_SHAPES]
K6_BWD_CASES = K6_BWD_TIMED + list(SMOKE.K6_BWD_EDGES)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", K6_BWD_CASES, ids=str)
def test_flash_attention_bwd_matches_plain_on_card(cuda, shape, dtype):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    b, h, kv, s, d, sk, causal, window = shape
    gen = torch.Generator(device=cuda).manual_seed(17)
    q, k, v, do, o, lse = SMOKE.k6_bwd_inputs(torch, cuda, gen, shape, dtype)
    before = ops.launch_counts()["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, o, do, lse, causal, window)
    again = flash_attention_bwd(q, k, v, o, do, lse, causal, window)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal, window)
    plain_o = flash_attention(q, k, v, causal, window)
    lse_ref = ref.flash_attention_lse_ref(q, k, v, causal, window)[1]
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_bwd"] == before + 2
    assert torch.equal(o, plain_o)
    assert ((lse - lse_ref).abs() / (1 + lse_ref.abs())).max() <= \
        SMOKE.K6_LSE_TOL
    for g, g2, w, noise in zip(got, again, want,
                               SMOKE.k6_bwd_noise(q, k, v, do)):
        assert torch.equal(g, g2)
        assert g.dtype == dtype and g.shape == w.shape
        ok, _, crit = SMOKE.k6_bwd_close(torch, g, w, noise)
        assert ok, crit
    if dtype == torch.bfloat16 and shape in K6_BWD_TIMED:
        ok, note = SMOKE.rounded_once(torch, got[2], want[2])
        assert ok, note


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K6_BWD_TIMED, ids=str)
def test_flash_attention_bwd_repeats_bit_identical_on_card(cuda, shape):
    """The bf16 kernel sums dQ (and a split span's dK/dV) in its unit
    list's order, counters deciding whose turn it is: 5 calls give the same
    bits, and so do 3 replays of one CUDA graph that captured a call, which
    holds only if the call zeroes its counters and ticket itself."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    b, h, kv, s, d, sk, causal, window = shape
    gen = torch.Generator(device=cuda).manual_seed(23)
    q, k, v, do, o, lse = SMOKE.k6_bwd_inputs(torch, cuda, gen, shape,
                                              torch.bfloat16)

    def call():
        return flash_attention_bwd(q, k, v, o, do, lse, causal, window)

    first = [t.clone() for t in call()]
    for _ in range(4):
        assert all(torch.equal(a, b_) for a, b_ in zip(first, call()))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(3):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b_) for a, b_ in zip(first, out))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K6_BWD_TIMED, ids=str)
def test_flash_attention_bwd_fp32_3xtf32_on_card(cuda, shape):
    """The fp32 backward (``flash_bwd_tf32_kernel``, 3xTF32 on mma.sync)
    at phase 7's timed shapes: within the bars of its plain version, each
    gradient's distance to the plain version run in float64 at most
    ``F64_WITNESS`` times the fp32 plain version's, 3 calls and 2 replays
    of a captured CUDA graph bit-identical (its dQ and split-span sums run
    in list order under counters the call zeroes)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    b, h, kv, s, d, sk, causal, window = shape
    gen = torch.Generator(device=cuda).manual_seed(29)
    q, k, v, do, o, lse = SMOKE.k6_bwd_inputs(torch, cuda, gen, shape,
                                              torch.float32)

    def call():
        return flash_attention_bwd(q, k, v, o, do, lse, causal, window)

    got = [t.clone() for t in call()]
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal, window)
    want64 = ref.flash_attention_bwd_ref(
        *(t.double() for t in (q, k, v, o, do, lse)), causal, window)
    for g, w, noise in zip(got, want, SMOKE.k6_bwd_noise(q, k, v, do)):
        ok, _, crit = SMOKE.k6_bwd_close(torch, g, w, noise)
        assert ok, crit
    ok, note = SMOKE.f64_witness(("dq", "dk", "dv"), got, want, want64)
    print(note)
    assert ok, note
    del want, want64
    for _ in range(2):
        assert all(torch.equal(a, b_) for a, b_ in zip(got, call()))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b_) for a, b_ in zip(got, out))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_autograd_launches_the_kernels_on_card(cuda, dtype):
    """``ops.flash_attention`` under autograd: one K6 (with its lse) and
    one K6 backward launch, gradients within the card bars of the plain
    backward, and a strided cotangent taken."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    shape = (2, 8, 2, 300, 64, 300, True, 0)
    q, k, v, do, o, lse = SMOKE.k6_bwd_inputs(torch, cuda, gen, shape, dtype)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = ops.launch_counts()
    out = ops.flash_attention(*leaves, True)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    assert torch.equal(out, o)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    for g, w, noise in zip(grads, want, SMOKE.k6_bwd_noise(q, k, v, do)):
        ok, _, crit = SMOKE.k6_bwd_close(torch, g, w, noise)
        assert ok, crit
    out = ops.flash_attention(*leaves, True)
    ones = torch.autograd.grad(out.float().sum(), leaves)
    do1 = torch.ones_like(o)
    for g, w, noise in zip(ones, ref.flash_attention_bwd_ref(
            q, k, v, o, do1, lse, True), SMOKE.k6_bwd_noise(q, k, v, do1)):
        assert SMOKE.k6_bwd_close(torch, g, w, noise)[0]


# K7's backward (ssd_scan_bwd.cu) against its plain version
# (ref.ssd_chunk_bwd_ref) at phase 7's shapes: Zamba2-1.2B's and
# mamba2-2.7b's training SSD (one B/C group broadcast to the heads) and the
# edges (per-head and grouped B/C, ragged chunks, Q <= 64, small N and P),
# with all three cotangents and with each alone; bars chip_smoke.
# k7_bwd_close (dx, dB, dC: fp32 within 1e-4 of their largest, bf16 rounded
# once; d(dt_a) within 1e-5 of its largest plus k7_bwd_noise); two calls
# bit-identical (no atomics: each group's heads summed in a fixed order)
K7_BWD_CASES = [shape for _, shape, _ in SMOKE.K7_BWD_SHAPES]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("given", SMOKE.K7_BWD_COTANGENTS, ids=str)
@pytest.mark.parametrize("shape", K7_BWD_CASES, ids=str)
def test_ssd_chunk_bwd_matches_plain_on_card(cuda, shape, given, dtype):
    from repro_torch.kernels.ssd_scan import ssd_chunk_bwd

    gen = torch.Generator(device=cuda).manual_seed(19)
    x, dt_a, b, c, *cots = SMOKE.k7_bwd_inputs(torch, cuda, gen, shape,
                                               dtype)
    use = [t if k else None for t, k in zip(cots, given)]
    g = shape[-1]
    before = ops.launch_counts()["ssd_chunk_bwd"]
    got = ssd_chunk_bwd(x, dt_a, b, c, *use, g)
    again = ssd_chunk_bwd(x, dt_a, b, c, *use, g)
    want = ref.ssd_chunk_bwd_ref(x, dt_a, b, c, *use, g)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_chunk_bwd"] == before + 2
    for t, t2 in zip(got, again):
        assert torch.equal(t, t2)
    ok, _, crit = SMOKE.k7_bwd_close(torch, got, want,
                                     SMOKE.k7_bwd_noise(x, b, c, *use))
    assert ok, crit


# bf16 K7 bwd at every heads-per-block choice of ssd_scan.SSD_BWD_HEADS
# that divides a group's heads, at phase 7's two training shapes (one B/C
# group), all three cotangents: each held at the bars, two calls
# bit-identical (phase 7 times the same sweep)
K7_BWD_SWEEP = [(shape, k) for name, shape, timed in SMOKE.K7_BWD_SHAPES
                if timed for k in SSD_BWD_HEADS
                if shape[2] // shape[5] % k == 0]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,heads", K7_BWD_SWEEP, ids=str)
def test_ssd_chunk_bwd_every_heads_per_block_on_card(cuda, shape, heads):
    from repro_torch.kernels.ssd_scan import ssd_chunk_bwd

    gen = torch.Generator(device=cuda).manual_seed(23)
    x, dt_a, b, c, *cots = SMOKE.k7_bwd_inputs(torch, cuda, gen, shape,
                                               torch.bfloat16)
    g = shape[-1]
    got = ssd_chunk_bwd(x, dt_a, b, c, *cots, g, heads=heads)
    again = ssd_chunk_bwd(x, dt_a, b, c, *cots, g, heads=heads)
    want = ref.ssd_chunk_bwd_ref(x, dt_a, b, c, *cots, g)
    torch.cuda.synchronize()
    for t, t2 in zip(got, again):
        assert torch.equal(t, t2)
    ok, _, crit = SMOKE.k7_bwd_close(torch, got, want,
                                     SMOKE.k7_bwd_noise(x, b, c, *cots))
    assert ok, crit


# the fp32 kernel (ssd_bwd_tf32_kernel, 3xTF32 on mma.sync) at every
# heads-per-block choice at phase 7's two training shapes
K7_BWD_F32_SWEEP = [(shape, k) for name, shape, timed in SMOKE.K7_BWD_SHAPES
                    if timed for k in SSD_BWD_HEADS
                    if shape[2] // shape[5] % k == 0]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,heads", K7_BWD_F32_SWEEP, ids=str)
def test_ssd_chunk_bwd_fp32_3xtf32_on_card(cuda, shape, heads):
    """The fp32 backward at each heads-a-block choice: within the bars of
    its plain version, two calls bit-identical, and at the plan's choice
    each gradient's distance to the plain version run in float64 at most
    ``F64_WITNESS`` times the fp32 plain version's."""
    from repro_torch.kernels.ssd_scan import ssd_bwd_plan, ssd_chunk_bwd

    gen = torch.Generator(device=cuda).manual_seed(31)
    x, dt_a, b, c, *cots = SMOKE.k7_bwd_inputs(torch, cuda, gen, shape,
                                               torch.float32)
    bc, q, h, p, n, g = shape
    got = ssd_chunk_bwd(x, dt_a, b, c, *cots, g, heads=heads)
    again = ssd_chunk_bwd(x, dt_a, b, c, *cots, g, heads=heads)
    want = ref.ssd_chunk_bwd_ref(x, dt_a, b, c, *cots, g)
    torch.cuda.synchronize()
    for t, t2 in zip(got, again):
        assert torch.equal(t, t2)
    ok, _, crit = SMOKE.k7_bwd_close(torch, got, want,
                                     SMOKE.k7_bwd_noise(x, b, c, *cots))
    assert ok, crit
    if heads == ssd_bwd_plan(bc, h, q, g, n):
        want64 = ref.ssd_chunk_bwd_ref(
            *(t.double() for t in (x, dt_a, b, c, *cots)), g)
        ok, note = SMOKE.f64_witness(("dx", "ddt", "db", "dc"), got, want,
                                     want64)
        print(note)
        assert ok, note


def nan_at(t: torch.Tensor, index: tuple, bits: int) -> None:
    """Write the fp32 NaN with these bits at ``index`` of ``t``."""
    t[index] = torch.tensor(bits - 2 ** 32 if bits >= 2 ** 31 else bits,
                            dtype=torch.int32).view(torch.float32).item()


def nan_needed(plain, args, poison) -> list[torch.Tensor]:
    """For each gradient of ``plain(*args)``, the entries that depend on
    the inputs at ``poison`` ((argument, index) pairs): those that the
    float64 run changes when each of those inputs moves by 1.  A NaN there
    must reach them; a dense product of the plain version also spreads it
    as 0·NaN over masked pairs, which are no dependence."""
    base = plain(*(t.double() for t in args))
    moved = [t.double() for t in args]
    for i, index in poison:
        moved[i][index] += 1.0
    return [a != b for a, b in zip(base, plain(*moved))]


def assert_nan_kept(names, got, needed) -> None:
    for name, g, need in zip(names, got, needed):
        assert need.any(), name
        lost = int((need & ~g.isnan()).sum())
        assert not lost, (f"{name}: {lost} of the {int(need.sum())} entries "
                          f"that depend on a NaN input are not NaN")


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF])
@pytest.mark.parametrize("shape", [(1, 4, 2, 300, 64, 300, True, 0),
                                   (1, 8, 2, 77, 128, 203, False, 0)],
                         ids=str)
def test_flash_attention_bwd_fp32_keeps_nan_on_card(cuda, shape, bits):
    """A NaN in q and one in dO reach every entry of the fp32 backward's
    gradients that depends on them, as in the plain version (3xTF32's
    split passes inf and NaN)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    b, h, kv, s, d, sk, causal, window = shape
    gen = torch.Generator(device=cuda).manual_seed(33)
    q, k, v, do, o, lse = SMOKE.k6_bwd_inputs(torch, cuda, gen, shape,
                                              torch.float32)
    args = [q, k, v, o, do, lse]
    poison = [(0, (0, 1, s // 2, 3)), (4, (0, h - 1, s // 3, 5))]
    needed = nan_needed(lambda *a: ref.flash_attention_bwd_ref(
        *a, causal, window), args, poison)
    for i, index in poison:
        nan_at(args[i], index, bits)
    assert_nan_kept(("dq", "dk", "dv"),
                    flash_attention_bwd(*args, causal, window), needed)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF])
@pytest.mark.parametrize("shape", [(2, 100, 8, 64, 128, 8),
                                   (2, 64, 4, 16, 16, 1)], ids=str)
def test_ssd_chunk_bwd_fp32_keeps_nan_on_card(cuda, shape, bits):
    """A NaN in x and one in dy reach every entry of the fp32 backward's
    gradients that depends on them."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_bwd

    bc, q, h, p, n, g = shape
    gen = torch.Generator(device=cuda).manual_seed(35)
    args = list(SMOKE.k7_bwd_inputs(torch, cuda, gen, shape, torch.float32))
    poison = [(0, (0, q // 2, 1, 3)), (4, (1, q // 3, h - 1, 5))]
    needed = nan_needed(lambda *a: ref.ssd_chunk_bwd_ref(*a, g), args,
                        poison)
    for i, index in poison:
        nan_at(args[i], index, bits)
    assert_nan_kept(("dx", "ddt", "db", "dc"), ssd_chunk_bwd(*args, g),
                    needed)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunk_autograd_launches_the_kernels_on_card(cuda, dtype,
                                                         groups):
    """``ops.ssd_chunk`` under autograd with group-shaped B and C: one K7
    and one K7 backward launch, gradients (dB, dC summed over each group)
    within the card bars of the plain backward, no plain version reached."""
    from repro_torch.kernels.ops import heads_of_groups

    gen = torch.Generator(device=cuda).manual_seed(6)
    bc, q, h, p, n = 4, 128, 8, 64, 64

    def rand(*size, dt=dtype):
        return torch.randn(*size, generator=gen, device=cuda).to(dt)

    x, dy = rand(bc, q, h, p), rand(bc, q, h, p)
    dt_a = -rand(bc, q, h, dt=torch.float32).abs() * 0.3
    b, c = rand(bc, q, groups, n), rand(bc, q, groups, n)
    dst, dd = rand(bc, h, p, n, dt=torch.float32), rand(bc, q, h,
                                                       dt=torch.float32)
    leaves = [t.detach().requires_grad_(True) for t in (x, dt_a, b, c)]
    before = ops.launch_counts()
    with SMOKE.PlainSpy(SMOKE.TRAIN_PLAIN_FNS) as spy:
        out = ops.ssd_chunk(*leaves)
        grads = torch.autograd.grad(out, leaves, (dy, dst, dd))
        torch.cuda.synchronize()
    after = ops.launch_counts()
    assert not any(spy.calls.values()), spy.calls
    assert after["ssd_chunk"] == before["ssd_chunk"] + 1
    assert after["ssd_chunk_bwd"] == before["ssd_chunk_bwd"] + 1
    bh, ch = heads_of_groups(b, h), heads_of_groups(c, h)
    want = ref.ssd_chunk_bwd_ref(x, dt_a, bh, ch, dy, dst, dd, groups)
    assert [tuple(t.shape) for t in grads] == [tuple(t.shape) for t in want]
    ok, _, crit = SMOKE.k7_bwd_close(torch, grads, want,
                                     SMOKE.k7_bwd_noise(x, bh, ch, dy, dst,
                                                        dd))
    assert ok, crit


# The fp32 forwards of K6 and K7 as 3xTF32 on mma.sync
# (``flash_fwd_tf32_kernel``, ``ssd_chunk_tf32_kernel``): at the paths'
# shapes (chip_smoke.K6_PATHS, K7_PATHS) and phase 7's edges, each output
# within phase 7's fp32 bars of its plain version, the paths' shapes also
# within the float64 witness (chip_smoke.f64_witness, 8x), repeats
# bit-identical.
K6_FP32_CASES = ([(*shape, 0) for shape in SMOKE.K6_PATHS.values()]
                 + [(1, 32, 32, 8, 64, 8, True, 0),
                    (2, 4, 4, 300, 128, 300, False, 0),
                    (1, 2, 2, 128, 32, 128, True, 0),
                    (1, 1, 1, 64, 128, 64, False, 0),
                    (1, 10, 2, 1, 128, 1, True, 0),
                    (1, 20, 4, 300, 64, 300, True, 0),
                    (1, 8, 2, 77, 128, 203, False, 0),
                    (2, 6, 3, 129, 32, 1, False, 0),
                    (1, 40, 8, 520, 128, 520, True, 129),
                    (1, 32, 32, 300, 64, 300, True, 1)])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K6_FP32_CASES, ids=str)
def test_flash_attention_fp32_3xtf32_on_card(cuda, shape):
    """fp32 K6 (B, H, KV, Sq, D, Sk, causal, window) against its plain
    version: o within K6_FP32_RTOL of its largest, the lse within
    K6_LSE_TOL·(1 + |ref|), o with the lse equal to o without, repeats
    bit-identical, one launch a call; window 1 returns v itself; at the
    paths' shapes the float64 witness."""
    from repro_torch.kernels.flash_attention import flash_attention

    b, h, kv, s, d, sk, causal, window = shape
    gen = torch.Generator(device=cuda).manual_seed(71)
    q = torch.randn(b, s, h, d, generator=gen, device=cuda).transpose(1, 2)
    k, v = (torch.randn(b, sk, kv, d, generator=gen, device=cuda)
            .transpose(1, 2) for _ in range(2))
    before = ops.launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, causal, window)
    o2, lse = flash_attention(q, k, v, causal, window, lse=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 2
    want, lse_r = ref.flash_attention_lse_ref(q, k, v, causal, window)
    _assert_rel(out, want, SMOKE.K6_FP32_RTOL)
    assert ((lse - lse_r).abs() / (1 + lse_r.abs())).max() <= SMOKE.K6_LSE_TOL
    assert torch.equal(out, o2)
    assert torch.equal(out, flash_attention(q, k, v, causal, window))
    if window == 1:
        assert torch.equal(out, v.repeat_interleave(h // kv, dim=1))
    if shape[:7] in SMOKE.K6_PATHS.values():
        want64 = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                         causal, window)
        ok, note = SMOKE.f64_witness(("o",), (out,), (want,), (want64,))
        assert ok, note


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF])
@pytest.mark.parametrize("shape", [(1, 4, 2, 300, 64, 300, True, 0),
                                   (1, 8, 2, 77, 128, 203, False, 0)],
                         ids=str)
def test_flash_attention_fp32_3xtf32_keeps_nan_on_card(cuda, shape, bits):
    """A NaN in q, one in k and one in v reach every entry of fp32 K6's
    output that depends on them, as in the plain version (3xTF32's split
    passes NaN)."""
    from repro_torch.kernels.flash_attention import flash_attention

    b, h, kv, s, d, sk, causal, window = shape
    gen = torch.Generator(device=cuda).manual_seed(73)
    args = [torch.randn(b, h, s, d, generator=gen, device=cuda),
            *(torch.randn(b, kv, sk, d, generator=gen, device=cuda)
              for _ in range(2))]
    poison = [(0, (0, 1, s // 2, 3)), (1, (0, 1, sk // 3, 5)),
              (2, (0, 0, sk // 4, 7))]
    needed = nan_needed(lambda *a: (ref.flash_attention_ref(*a, causal),),
                        args, poison)
    for i, index in poison:
        nan_at(args[i], index, bits)
    assert_nan_kept(("o",), (flash_attention(*args, causal),), needed)


K7_FP32_CASES = ([(*shape, True) for shape in SMOKE.K7_PATHS.values()]
                 + [(1, 128, 64, 64, 64, True), (2, 100, 8, 64, 128, True),
                    (2, 100, 8, 64, 128, False), (3, 128, 4, 64, 96, False),
                    (2, 77, 6, 32, 128, True), (1, 128, 3, 64, 72, False),
                    (1, 64, 2, 30, 90, True), (2, 16, 8, 8, 4, False)])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K7_FP32_CASES, ids=str)
def test_ssd_chunk_fp32_3xtf32_on_card(cuda, shape):
    """fp32 K7 (BC, Q, H, P, N, stride-0 B/C) against its plain version: y,
    the state and the decay within K7_FP32_RTOL of their largest, one
    launch a call; every heads a block the kernel takes (SSD_BWD_HEADS
    dividing H where B/C are stride-0, else 1) gives the same bits (S is
    formed once a block from the group's B and C); at the paths' shapes
    the float64 witness."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ssd_chunk

    bc, q, h, p, n, shared = shape
    rng = np.random.default_rng(75)
    x, dt_a, b, c = _ssd_inputs_on_card(rng, cuda, bc, q, h, p, n,
                                        torch.float32, shared)
    before = ops.launch_counts()["ssd_chunk"]
    got = ssd_chunk(x, dt_a, b, c)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_chunk"] == before + 1
    want = ref.ssd_chunk_ref(x, dt_a, b, c)
    for g_, w in zip(got, want):
        _assert_rel(g_, w, SMOKE.K7_FP32_RTOL)

    def run(heads):
        y = torch.empty_like(x)
        st = torch.empty((bc, h, p, n), device=cuda)
        dec = torch.empty((bc, q, h), device=cuda)
        _build.extension().ssd_chunk(x, dt_a, b, c, y, st, dec, heads)
        return y, st, dec

    for heads in (k_ for k_ in SSD_BWD_HEADS if h % k_ == 0 and
                  (shared or k_ == 1)):
        assert all(torch.equal(a, a2) for a, a2 in zip(got, run(heads)))
    if shape[:5] in SMOKE.K7_PATHS.values():
        want64 = ref.ssd_chunk_ref(x.double(), dt_a.double(), b.double(),
                                   c.double())
        ok, note = SMOKE.f64_witness(("y", "state", "decay"), got, want,
                                     want64)
        assert ok, note


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF])
@pytest.mark.parametrize("shared", [True, False])
def test_ssd_chunk_fp32_3xtf32_keeps_nan_on_card(cuda, shared, bits):
    """A NaN in x, one in B and one in C (in the group's one row where B/C
    are stride-0) reach every entry of fp32 K7's y and state that depends
    on them."""
    from repro_torch.kernels.ssd_scan import ssd_chunk

    bc, q, h, p, n = 2, 128, 8, 64, 64
    g = 1 if shared else h
    gen = torch.Generator(device=cuda).manual_seed(77)
    args = [torch.randn(bc, q, h, p, generator=gen, device=cuda),
            -torch.randn(bc, q, h, generator=gen, device=cuda).abs() * 0.3,
            *(torch.randn(bc, q, g, n, generator=gen, device=cuda)
              for _ in range(2))]

    def heads_of(x, dt_a, b, c):
        return (x, dt_a, *(t.expand(bc, q, h, n) for t in (b, c)))

    poison = [(0, (0, q // 2, 1, 3)), (2, (1, q // 3, 0, 5)),
              (3, (1, q // 2, 0, 7))]
    needed = nan_needed(lambda *a: ref.ssd_chunk_ref(*heads_of(*a)), args,
                        poison)
    for i, index in poison:
        nan_at(args[i], index, bits)
    assert_nan_kept(("y", "state"), ssd_chunk(*heads_of(*args))[:2],
                    needed[:2])
