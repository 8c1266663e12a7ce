"""K1 and K2 on the tensor cores (bf16 weights), and K3 (bf16 x): their
method, host plans, cost and dispatch, on the CPU.

``csrc/fcnn_fwd_tc.cu``, ``csrc/fcnn_dgrad_tc.cu`` and
``csrc/fcnn_wgrad_tc.cu`` run only on the card, where ``chip_smoke.py``
phase 23 and ``tests/test_torch_kernels_gpu.py`` hold them to their plain
versions.  Here:

  * the method, written in torch as the kernels compute it (an fp32
    operand, K1's x in case (b) and K2's dZ always, split into hi =
    bf16(v) and lo = bf16(v − hi); each part times the bf16 weights,
    summed in fp32; a bf16 output rounded once), against the JAX
    reference's Pallas kernels in interpret mode, as the reference's own
    tests run them, at phase 23's bars (``chip_smoke.gemm_close``: an fp32
    output within 1e-4 of its largest, a bf16 one element-wise within one
    bf16 ulp plus 1e-4 of its largest and norm-wise within one ulp);
  * a check that can fail: the fp32 operand rounded to bf16 alone lands
    past the fp32 bar and far from the reference, hi + lo well within it;
  * every plan at NN1-NN6's layers, batch 64 and 128, and the ragged
    shapes fits the kernels' limits;
  * a bf16 w reaches the tensor-core entry and an fp32 w the CUDA-core
    one, through the wrappers with a stand-in extension.

And for K3, whose dZ is fp32 and x bf16 (cases (a) and (d)):

  * the method, written in torch as the kernel computes it (dZ = dY ⊙
    A'(Y) in fp32, split into hi and lo; each part times the bf16 x,
    summed in fp32; dW rounded once to x's dtype; db summed from the fp32
    dZ and rounded once to dy's), against the reference's Pallas wgrad in
    interpret mode at phase 23's bars, with dy and y in bf16 and in fp32,
    at every activation;
  * a check that can fail: before the rounding, the hi + lo accumulator
    stays within 1e-5 of the largest of the fp32 product Xᵀ·dZ, and dZ
    rounded to bf16 alone lands past that bar; after it, the method's dW
    holds ``chip_smoke.rounded_once`` against the fp32 product rounded
    once (the bar phase 23 holds the kernel to), and bf16-alone misses it;
  * every ``wgrad_tc_plan`` fits the kernel's limits, and at NN1's and
    NN5's layers picks what phase 23's sweep measured fastest;
  * the cost of a launch counted by the kernel that runs it (K2's narrow
    rule too), and a meta call reporting it;
  * bf16 x reaches ``fcnn_wgrad_tc`` at every width (the output layers'
    10 too), fp32 x ``fcnn_wgrad``; a bf16-w K2 at a contraction N <=
    TC_NARROW reaches ``fcnn_dgrad`` with ``dgrad_plan``'s choice;
    ``tc_launches`` counts.
"""

import importlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fcnn_layer import (
    fcnn_layer as j_fwd,
    fcnn_layer_dgrad as j_dgrad,
    fcnn_layer_wgrad as j_wgrad,
)
from repro_torch.configs.nn_benchmarks import NN_BENCHMARKS
from repro_torch.core.planner import H100Target
from repro_torch.kernels import cost, ops, ref

FL = importlib.import_module("repro_torch.kernels.fcnn_layer")

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)

# (x dtype, w dtype) of the cases that reach the tensor cores; dy and y
# take x's
CASES = {"a": ("bfloat16", "bfloat16"), "b": ("float32", "bfloat16")}
# NN1 (784-1000-500-10, batch 64) and NN5 (1024-4000-1000-4000-10, batch
# 128) narrowed for interpret mode, and phase 23's ragged shapes
NN1_NARROW = (64, [784, 256, 128, 10])
NN5_NARROW = (32, [256, 1000, 250, 1000, 10])
SHAPES = [(m, k, n) for m, sizes in (NN1_NARROW, NN5_NARROW)
          for k, n in zip(sizes[:-1], sizes[1:])] + list(SMOKE.BF16_RAGGED)
SMEM_LIMIT = 232448      # bytes of shared memory a block may opt into
CLUSTER_LIMIT = 16       # blocks of a non-portable cluster
ACC_RTOL = 1e-5          # K3's accumulator against the fp32 product


def _split(v: torch.Tensor):
    """fp32 v as bf16 hi + lo (hi = bf16(v), lo = bf16(v − hi))."""
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


def _times_w(a: torch.Tensor, w: torch.Tensor, split: bool) -> torch.Tensor:
    """a · w as the kernels take it: bf16 a once; fp32 a split in two (or,
    where not ``split``, rounded to bf16 once: the check that can fail)."""
    if a.dtype == torch.bfloat16:
        parts = (a,)
    elif split:
        parts = _split(a)
    else:
        parts = (a.to(torch.bfloat16),)
    return sum(p.float() @ w.float() for p in parts)


def tc_fwd(x, w, b, act, split=True):
    """K1's tensor-core method: act(x · w + b) in fp32, rounded once to
    x's dtype."""
    z = _times_w(x, w, split) + b.float()
    return ref.apply_activation(z, act).to(x.dtype)


def tc_dgrad(dy, y, w, act, split=True):
    """K2's tensor-core method: dZ = dY ⊙ A'(Y) in fp32, times Wᵀ as
    hi + lo, rounded once to dy's dtype."""
    dz = dy.float() * ref.act_deriv_from_output(y.float(), act)
    return _times_w(dz, w.T, split).to(dy.dtype)


def _inputs(m, k, n, case, act, seed=0):
    """x, w, b, dy and y (the reference's forward) as jax arrays of the
    case's dtypes, and the same as CPU tensors."""
    xd, wd = (getattr(jnp, d) for d in CASES[case])
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(m, k)), xd)
    w = jnp.asarray(rng.normal(size=(k, n)) * k ** -0.5, wd)
    b = jnp.asarray(rng.normal(size=(n,)) * 0.1, wd)
    dy = jnp.asarray(rng.normal(size=(m, n)) * 0.01, xd)
    y = j_fwd(x, w, b, act, interpret=True)
    return (x, w, b, dy, y), tuple(map(_torch, (x, w, b, dy, y)))


def _torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(ours, theirs) -> tuple[bool, str]:
    ok, _, note = SMOKE.gemm_close(torch, ours, _torch(theirs))
    return ok, note


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_method_matches_reference_pallas(m, k, n, case):
    """K1's and K2's method within phase 23's bars of the reference's
    Pallas kernels (interpret mode) in cases (a) and (b)."""
    act = "sigmoid" if n > 10 else "none"
    (x, w, b, dy, y), (tx, tw, tb, tdy, ty) = _inputs(m, k, n, case, act)
    ok, note = _close(tc_fwd(tx, tw, tb, act), y)
    assert ok, ("fwd", note)
    want = j_dgrad(dy, y, w, act, interpret=True)
    ok, note = _close(tc_dgrad(tdy, ty, tw, act), want)
    assert ok, ("dgrad", note)


@pytest.mark.parametrize("m,k,n", [(64, 784, 256), (32, 1000, 250),
                                   (32, 250, 1000)])
def test_bf16_alone_lands_far_from_reference(m, k, n):
    """In case (b) both outputs are fp32: rounding x (K1) or dZ (K2) to
    bf16 alone misses the reference by more than the fp32 bar and by more
    than 20 times what hi + lo misses it by, which stays within the bar."""
    (x, w, b, dy, y), (tx, tw, tb, tdy, ty) = _inputs(m, k, n, "b",
                                                      "sigmoid", seed=3)
    want_y = _torch(y).double()
    want_dx = _torch(j_dgrad(dy, y, w, "sigmoid", interpret=True)).double()

    def rel(out, want):
        return ((out.double() - want).abs().max() / want.abs().max()).item()

    for what, fn, args, want in (
            ("fwd", tc_fwd, (tx, tw, tb, "sigmoid"), want_y),
            ("dgrad", tc_dgrad, (tdy, ty, tw, "sigmoid"), want_dx)):
        hilo = rel(fn(*args), want)
        alone = rel(fn(*args, split=False), want)
        assert hilo <= SMOKE.GEMM_RTOL, (what, hilo)
        assert alone > SMOKE.GEMM_RTOL, (what, alone)
        assert alone > 20 * hilo, (what, alone, hilo)


def _plan_shapes():
    """(m, k, n) of every layer of NN1-NN6 at batch 64 and 128, and the
    ragged shapes."""
    shapes = set(SMOKE.BF16_RAGGED)
    for sizes in NN_BENCHMARKS.values():
        for batch in (64, 128):
            shapes.update((batch, k, n) for k, n in zip(sizes[:-1],
                                                          sizes[1:]))
    return sorted(shapes)


@pytest.mark.parametrize("m,k,n", _plan_shapes())
def test_tc_plans_fit_the_kernels(m, k, n):
    """Each entry's plan: a width it is built for, a power-of-two split of
    at most 16 (a cluster) that leaves every rank a slice, a grid within
    its block slots, and a ring within the shared memory a block may
    take, in both x dtypes."""
    limits = FL.TC_LIMITS
    for plan, widths, cols, contraction, smem in (
            (FL.fwd_tc_plan(m, k, n), FL.FWD_TC_WIDTHS, n, k, FL.fwd_tc_smem),
            (FL.dgrad_tc_plan(m, k, n), FL.DGRAD_TC_WIDTHS, k, n,
             FL.dgrad_tc_smem)):
        width, split = plan
        assert width in widths
        assert split & (split - 1) == 0 and 1 <= split <= CLUSTER_LIMIT
        assert split <= limits[0]
        assert split <= -(-contraction // FL.TC_SLICE)
        blocks = -(-m // 64) * -(-cols // width) * split
        assert split == 1 or blocks <= limits[1]
        for size in (2, 4):
            assert smem(size, width) <= SMEM_LIMIT


def test_tc_ring_depths():
    """The shared memory the source reckons: K1 with bf16 x at width 64
    keeps 6 stages of 16 KB (x 8 KB, w 8 KB), with fp32 x 4 of 26 KB; K2's
    fp32 dY and Y at width 128 keep the least, 3 stages of 52 KB."""
    assert FL.fwd_tc_smem(2, 64) == 6 * 16384 + 1024
    assert FL.fwd_tc_smem(4, 64) == 4 * (18432 + 8192) + 1024
    assert FL.dgrad_tc_smem(4, 128) == 3 * (2 * 18432 + 16384) + 1024
    assert FL.fwd_tc_smem(2, 16) == 8 * (8192 + 2048) + 1024


class _Extension:
    """Stands in for the built extension: records which entry each call
    reached, with the dtype that picked it (w's, K3's x's), and its plan,
    and writes the plain version's result into the outputs."""

    def __init__(self):
        self.calls, self.plans = [], []

    def _call(self, entry, dtype, *plan):
        self.calls.append((entry, dtype))
        self.plans.append((entry, plan))

    def fcnn_fwd(self, x, w, b, out, act, split, slice_):
        self._call("fcnn_fwd", w.dtype, split, slice_)
        out.copy_(ref.fcnn_layer_ref(x, w, b, _act(act)))

    def fcnn_fwd_tc(self, x, w, b, out, act, width, split):
        self._call("fcnn_fwd_tc", w.dtype, width, split)
        out.copy_(ref.fcnn_layer_ref(x, w, b, _act(act)))

    def fcnn_dgrad(self, dy, y, w, dx, act, split, slice_):
        self._call("fcnn_dgrad", w.dtype, split, slice_)
        dx.copy_(ref.fcnn_layer_dgrad_ref(dy, y, w, _act(act)))

    def fcnn_dgrad_tc(self, dy, y, w, dx, act, width, split):
        self._call("fcnn_dgrad_tc", w.dtype, width, split)
        dx.copy_(ref.fcnn_layer_dgrad_ref(dy, y, w, _act(act)))

    def fcnn_wgrad(self, x, dy, y, dw, db, act, rows, cols):
        self._call("fcnn_wgrad", x.dtype, rows, cols)
        for out, want in zip((dw, db), ref.fcnn_layer_wgrad_ref(
                x, dy, y, _act(act))):
            out.copy_(want)

    def fcnn_wgrad_tc(self, x, dy, y, dw, db, act, width, split):
        self._call("fcnn_wgrad_tc", x.dtype, width, split)
        for out, want in zip((dw, db), ref.fcnn_layer_wgrad_ref(
                x, dy, y, _act(act))):
            out.copy_(want)


def _act(code: int) -> str:
    return {v: k for k, v in FL.ACT_CODES.items()}[code]


@pytest.mark.parametrize("xd,wd", [("bfloat16", "bfloat16"),
                                   ("float32", "bfloat16"),
                                   ("float32", "float32"),
                                   ("bfloat16", "float32")])
def test_bf16_w_reaches_the_tensor_core_entry(monkeypatch, xd, wd):
    """With the tensors taken for CUDA ones, bf16 w (cases (a), (b))
    launches fcnn_fwd_tc / fcnn_dgrad_tc and counts in ``launches`` and
    ``tc_launches``; fp32 w (cases (c), (d)) launches fcnn_fwd /
    fcnn_dgrad and counts in ``launches`` only."""
    ext = _Extension()
    monkeypatch.setattr(FL, "device_type", lambda kernel, *t: "cuda")
    monkeypatch.setattr(FL._build, "extension", lambda: ext)
    ops.reset_launches()
    xd, wd = getattr(torch, xd), getattr(torch, wd)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 100, generator=g).to(xd)
    w = (torch.randn(100, 30, generator=g) * 0.1).to(wd)
    b = torch.randn(30, generator=g).to(wd)
    y = FL.fcnn_layer(x, w, b, "sigmoid")
    FL.fcnn_layer_dgrad(torch.ones_like(y), y, w, "sigmoid")
    tc = wd == torch.bfloat16
    assert ext.calls == [("fcnn_fwd_tc" if tc else "fcnn_fwd", wd),
                         ("fcnn_dgrad_tc" if tc else "fcnn_dgrad", wd)]
    assert FL.fcnn_layer.launches == FL.fcnn_layer_dgrad.launches == 1
    assert FL.fcnn_layer.tc_launches == FL.fcnn_layer_dgrad.tc_launches \
        == int(tc)
    ops.reset_launches()
    assert FL.fcnn_layer.tc_launches == FL.fcnn_layer_dgrad.tc_launches == 0


# ------------------------------------------------------------------ K3

def _dz(dy, y, act):
    return dy.float() * ref.act_deriv_from_output(y.float(), act)


def tc_accumulator(x, dz, split=True):
    """dWᵀ's fp32 accumulator as the kernel forms it, transposed back:
    Σ over dZ's parts (hi and lo, or, where not ``split``, dZ rounded to
    bf16 once: the check that can fail) of Xᵀ·part."""
    parts = _split(dz) if split else (dz.to(torch.bfloat16),)
    return sum(x.float().T @ p.float() for p in parts)


def tc_wgrad(x, dy, y, act):
    """K3's tensor-core method: (dW, db) = (Xᵀ·(hi + lo) rounded once to
    x's dtype, Σ_rows dZ in fp32 rounded once to dy's)."""
    dz = _dz(dy, y, act)
    return tc_accumulator(x, dz).to(x.dtype), dz.sum(0).to(dy.dtype)


def _wgrad_inputs(m, k, n, dy_dtype, act, seed=0):
    """x (bf16), dy and y (``dy_dtype``; y an activation's output range) as
    jax arrays, and the same as CPU tensors."""
    rng = np.random.default_rng(seed)
    dd = getattr(jnp, dy_dtype)
    x = jnp.asarray(rng.normal(size=(m, k)), jnp.bfloat16)
    z = rng.normal(size=(m, n))
    y = {"sigmoid": 1 / (1 + np.exp(-z)), "relu": np.maximum(z, 0),
         "tanh": np.tanh(z), "none": z}[act]
    y = jnp.asarray(y, dd)
    dy = jnp.asarray(rng.normal(size=(m, n)) * 0.01, dd)
    return (x, dy, y), tuple(map(_torch, (x, dy, y)))


@pytest.mark.parametrize("dy_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act", SMOKE.ACTS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_wgrad_tc_method_matches_reference_pallas(m, k, n, act, dy_dtype):
    """K3's tensor-core method within phase 23's bars of the reference's
    Pallas kernel (interpret mode): dW in x's dtype (bf16), db in dy's."""
    (x, dy, y), (tx, tdy, ty) = _wgrad_inputs(m, k, n, dy_dtype, act)
    want_dw, want_db = j_wgrad(x, dy, y, act, interpret=True)
    dw, db = tc_wgrad(tx, tdy, ty, act)
    for what, ours, theirs in (("dW", dw, want_dw), ("db", db, want_db)):
        ok, _, note = SMOKE.gemm_close(torch, ours, _torch(theirs))
        assert ok, (what, note)


@pytest.mark.parametrize("m,k,n", [(64, 784, 256), (32, 256, 1000),
                                   (128, 1000, 500)])
def test_wgrad_accumulator_hilo_holds_and_bf16_alone_fails(m, k, n):
    """Before dW's rounding: Xᵀ·(hi + lo) within ACC_RTOL of the largest of
    the fp32 product Xᵀ·dZ, and Xᵀ·bf16(dZ) past that bar by more than 20
    times what hi + lo misses it by."""
    (_, _, _), (x, dy, y) = _wgrad_inputs(m, k, n, "bfloat16", "sigmoid", seed=3)
    dz = _dz(dy, y, "sigmoid")
    want = (x.float().T @ dz).double()

    def rel(acc):
        return ((acc.double() - want).abs().max() / want.abs().max()).item()

    hilo, alone = rel(tc_accumulator(x, dz)), rel(tc_accumulator(x, dz, False))
    assert hilo <= ACC_RTOL, hilo
    assert alone > ACC_RTOL, alone
    assert alone > 20 * hilo, (alone, hilo)


@pytest.mark.parametrize("dy_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act", ["sigmoid", "tanh"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_wgrad_tc_method_is_the_product_rounded_once(m, k, n, act, dy_dtype):
    """The bar phase 23 holds K3's dW to where x is bf16 (``rounded_once``):
    the hi/lo method's dW against the fp32 product Xᵀ·dZ rounded once to
    bf16 holds it, and dZ rounded to bf16 alone misses it."""
    (_, _, _), (x, dy, y) = _wgrad_inputs(m, k, n, dy_dtype, act, seed=5)
    want, _ = ref.fcnn_layer_wgrad_ref(x, dy, y, act)
    dz = _dz(dy, y, act)
    held, note = SMOKE.rounded_once(torch, tc_accumulator(x, dz).to(x.dtype),
                                    want)
    assert held, note
    alone = tc_accumulator(x, dz, False).to(x.dtype)
    assert not SMOKE.rounded_once(torch, alone, want)[0]


@pytest.mark.parametrize("m,k,n", _plan_shapes())
def test_wgrad_tc_plan_fits_the_kernel(m, k, n):
    """The plan: a width the kernel is built for, a power-of-two split of
    at most 16 (a cluster) that leaves every rank a batch slice, a grid
    within its block slots, and a ring (and the epilogue's partials and
    dW tile inside it) within the shared memory a block may take, with dy
    in bf16 and in fp32."""
    width, split = FL.wgrad_tc_plan(m, k, n)
    assert width in FL.WGRAD_TC_WIDTHS
    assert split & (split - 1) == 0 and 1 <= split <= CLUSTER_LIMIT
    assert split <= FL.TC_LIMITS[0]
    assert split <= -(-m // FL.TC_SLICE)
    blocks = -(-n // FL.TC_ROWS) * -(-k // width) * split
    assert split == 1 or blocks <= FL.TC_LIMITS[1]
    for size in (2, 4):
        smem = FL.wgrad_tc_smem(size, width)
        assert smem <= SMEM_LIMIT
        epilogue = FL.TC_ROWS * (width + 8) * 4 + width * (FL.TC_ROWS + 8) * 2
        assert epilogue <= smem - 1024
        # the stages this launch takes: every slice of a rank, the epilogue
        used = FL.wgrad_tc_smem(size, width, m, split)
        assert epilogue <= used - 1024 and used <= smem


@pytest.mark.parametrize("m,k,n,plan", [
    (64, 784, 1000, (64, 1)), (64, 1000, 500, (64, 1)), (64, 500, 10, (64, 1)),
    (128, 1024, 4000, (128, 1)), (128, 4000, 1000, (128, 1)),
    (128, 1000, 4000, (128, 1)), (128, 4000, 10, (64, 2))])
def test_wgrad_tc_plan_picks_the_swept_best(m, k, n, plan):
    """At NN1's and NN5's layers the plan picks what phase 23's sweep
    measured fastest on the H100: width 64 where its grid fits two blocks
    an SM (NN1), 128 past that (NN5 L1-L3), split 2 where the grid would
    leave half the SMs idle (NN5 L4)."""
    assert FL.wgrad_tc_plan(m, k, n) == plan


def test_wgrad_tc_ring_depths():
    """The shared memory the source reckons: bf16 dY at width 128 keeps 3
    stages of 34 KB (X 16 KB, dY and Y 9 KB each), at width 64 4 of 26 KB;
    fp32 dY (rows padded to 68) 3 of 50 KB and 3 of 42 KB."""
    assert FL.wgrad_tc_smem(2, 128) == 3 * (16384 + 2 * 9216) + 1024
    assert FL.wgrad_tc_smem(2, 64) == 4 * (8192 + 2 * 9216) + 1024
    assert FL.wgrad_tc_smem(4, 128) == 3 * (16384 + 2 * 17408) + 1024
    assert FL.wgrad_tc_smem(4, 64) == 3 * (8192 + 2 * 17408) + 1024
    # a launch takes a rank's slices, no fewer than the epilogue's stages
    assert FL.wgrad_tc_smem(2, 64, 128) == 2 * (8192 + 2 * 9216) + 1024
    assert FL.wgrad_tc_smem(4, 64, 64) == 8192 + 2 * 17408 + 1024
    assert FL.wgrad_tc_smem(4, 64, 128) == 2 * (8192 + 2 * 17408) + 1024
    assert FL.wgrad_tc_smem(4, 64, 128, 2) == 8192 + 2 * 17408 + 1024
    assert FL.wgrad_tc_smem(4, 128, 64) == 2 * (16384 + 2 * 17408) + 1024
    assert FL.wgrad_tc_smem(2, 128, 4096, 2) == FL.wgrad_tc_smem(2, 128)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("m", [64, 128])
def test_wgrad_tc_width_64_leaves_room_for_two_blocks(m, size):
    """WGRAD_TC_SLOTS' premise: at NN1's and NN5's batches a width-64
    launch takes only its one or two slices' stages (and the epilogue's),
    so two blocks, each with the 1 KB the card reserves, fit an SM's 228 KB,
    with dY in bf16 and in fp32; the whole ring would not with fp32 dY."""
    assert FL.WGRAD_TC_SLOTS == 2 * FL.TC_LIMITS[1]
    sm = 228 * 1024
    assert 2 * (FL.wgrad_tc_smem(size, 64, m, 1) + 1024) <= sm
    assert 2 * (FL.wgrad_tc_smem(4, 64) + 1024) > sm


@pytest.mark.parametrize("x_size,n,tc", [(2, 4000, True), (2, 10, True),
                                         (4, 4000, False), (4, 10, False)])
def test_wgrad_cost_counts_the_kernel_that_runs(x_size, n, tc):
    """K3's products counted as its kernel runs them: bf16 x (at every
    width) twice at the bf16 rate (dZ's hi and lo), fp32 x once in fp32;
    the element-wise work and the bytes either way.  At NN5 L1 in case (a)
    the bound is bytes, 0.00314 ms."""
    m, k = 128, 1024
    c = cost.fcnn_wgrad(m, k, n, x_size, 2)
    product = {"bfloat16": 2 * 2 * m * k * n} if tc else {
        "float32": 2 * m * k * n}
    want = dict(product)
    want["float32"] = want.get("float32", 0) + 3 * m * n
    assert c.flops == want
    assert c.nbytes == x_size * (m * k + k * n) + 2 * (2 * m * n + n)
    if n == 4000 and tc:
        t_ops, t_bytes = (t * 1e3 for t in c.seconds(H100Target()))
        assert t_bytes > t_ops
        assert round(t_bytes, 5) == 0.00314


@pytest.mark.parametrize("n,tc", [(500, True), (10, False)])
def test_dgrad_cost_counts_the_kernel_that_runs(n, tc):
    """K2 with bf16 w: twice at the bf16 rate above TC_NARROW, once in
    fp32 at or below it (the CUDA-core kernel)."""
    m, k = 64, 1000
    c = cost.fcnn_dgrad(m, k, n, 2, 2)
    want = ({"bfloat16": 2 * 2 * m * n * k, "float32": 2 * m * n} if tc
            else {"float32": 2 * m * n * k + 2 * m * n})
    assert c.flops == want


class _Recorder:
    def __init__(self):
        self.seen = []

    def kernel(self, name, c):
        self.seen.append((name, c))


def test_meta_wgrad_reports_the_tensor_core_cost():
    """A bf16-x K3 call on meta reports the tensor-core kernel's cost and
    returns outputs in the reference's dtypes, launching nothing."""
    x = torch.empty(128, 1024, device="meta", dtype=torch.bfloat16)
    dy = torch.empty(128, 4000, device="meta", dtype=torch.bfloat16)
    ops.reset_launches()
    with cost.recording(_Recorder()) as rec:
        dw, db = FL.fcnn_layer_wgrad(x, dy, dy, "sigmoid")
    assert (dw.dtype, db.dtype, tuple(dw.shape)) == (
        torch.bfloat16, torch.bfloat16, (1024, 4000))
    assert rec.seen == [("fcnn_layer_wgrad",
                         cost.fcnn_wgrad(128, 1024, 4000, 2, 2))]
    assert "bfloat16" in rec.seen[0][1].flops
    assert FL.fcnn_layer_wgrad.launches == FL.fcnn_layer_wgrad.tc_launches == 0


@pytest.fixture
def ext(monkeypatch):
    """The stand-in extension, with every tensor taken for a CUDA one."""
    stand_in = _Extension()
    monkeypatch.setattr(FL, "device_type", lambda kernel, *t: "cuda")
    monkeypatch.setattr(FL._build, "extension", lambda: stand_in)
    ops.reset_launches()
    yield stand_in
    ops.reset_launches()


@pytest.mark.parametrize("xd,dyd,n,entry", [
    ("bfloat16", "bfloat16", 500, "fcnn_wgrad_tc"),
    ("bfloat16", "float32", 500, "fcnn_wgrad_tc"),
    ("bfloat16", "bfloat16", 16, "fcnn_wgrad_tc"),
    ("bfloat16", "bfloat16", 10, "fcnn_wgrad_tc"),
    ("float32", "float32", 500, "fcnn_wgrad"),
    ("float32", "float32", 10, "fcnn_wgrad"),
    ("float32", "bfloat16", 500, "fcnn_wgrad")])
def test_wgrad_dispatch_by_x(ext, xd, dyd, n, entry):
    """bf16 x, at every width, reaches the tensor-core entry with
    ``wgrad_tc_plan``'s choice and counts in ``launches`` and
    ``tc_launches``; fp32 x the CUDA-core entry with ``wgrad_plan``'s, in
    ``launches`` only; outputs in the reference's dtypes."""
    m, k = 64, 1000
    g = torch.Generator().manual_seed(0)
    x = torch.randn(m, k, generator=g).to(getattr(torch, xd))
    y = torch.rand(m, n, generator=g).to(getattr(torch, dyd))
    dy = (torch.randn(m, n, generator=g) * 0.01).to(getattr(torch, dyd))
    dw, db = FL.fcnn_layer_wgrad(x, dy, y, "sigmoid")
    plan = (FL.wgrad_tc_plan(m, k, n) if entry == "fcnn_wgrad_tc"
            else FL.wgrad_plan(k, n))
    assert ext.plans == [(entry, plan)]
    assert (dw.dtype, db.dtype) == (x.dtype, dy.dtype)
    assert FL.fcnn_layer_wgrad.launches == 1
    assert FL.fcnn_layer_wgrad.tc_launches == int(entry == "fcnn_wgrad_tc")


@pytest.mark.parametrize("wd,n,entry", [
    ("bfloat16", 500, "fcnn_dgrad_tc"), ("bfloat16", 17, "fcnn_dgrad_tc"),
    ("bfloat16", 16, "fcnn_dgrad"), ("bfloat16", 10, "fcnn_dgrad"),
    ("float32", 500, "fcnn_dgrad")])
def test_dgrad_narrow_contraction_stays_on_the_cuda_cores(ext, wd, n, entry):
    """bf16 w at a contraction N <= TC_NARROW reaches the CUDA-core entry
    with ``dgrad_plan``'s (split, slice), counting in ``launches`` only;
    above it the tensor-core entry with ``dgrad_tc_plan``'s."""
    m, k = 64, 500
    g = torch.Generator().manual_seed(1)
    dy = (torch.randn(m, n, generator=g) * 0.01).to(torch.bfloat16)
    y = torch.rand(m, n, generator=g).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g) * 0.05).to(getattr(torch, wd))
    FL.fcnn_layer_dgrad(dy, y, w, "sigmoid")
    plan = (FL.dgrad_tc_plan(m, k, n) if entry == "fcnn_dgrad_tc"
            else FL.dgrad_plan(m, k, n))
    assert ext.plans == [(entry, plan)]
    assert FL.fcnn_layer_dgrad.launches == 1
    assert FL.fcnn_layer_dgrad.tc_launches == int(entry == "fcnn_dgrad_tc")
