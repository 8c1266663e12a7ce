"""K1 and K2 on the tensor cores (bf16 weights): their method, host plans
and dispatch, on the CPU.

``csrc/fcnn_fwd_tc.cu`` and ``csrc/fcnn_dgrad_tc.cu`` run only on the card,
where ``chip_smoke.py`` phase 23 and ``tests/test_torch_kernels_gpu.py``
hold them to their plain versions.  Here:

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
)
from repro_torch.configs.nn_benchmarks import NN_BENCHMARKS
from repro_torch.kernels import ops, ref

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
    reached and writes the plain version's result into the output."""

    def __init__(self):
        self.calls = []

    def fcnn_fwd(self, x, w, b, out, act, split, slice_):
        self.calls.append(("fcnn_fwd", w.dtype))
        out.copy_(ref.fcnn_layer_ref(x, w, b, _act(act)))

    def fcnn_fwd_tc(self, x, w, b, out, act, width, split):
        self.calls.append(("fcnn_fwd_tc", w.dtype))
        out.copy_(ref.fcnn_layer_ref(x, w, b, _act(act)))

    def fcnn_dgrad(self, dy, y, w, dx, act, split, slice_):
        self.calls.append(("fcnn_dgrad", w.dtype))
        dx.copy_(ref.fcnn_layer_dgrad_ref(dy, y, w, _act(act)))

    def fcnn_dgrad_tc(self, dy, y, w, dx, act, width, split):
        self.calls.append(("fcnn_dgrad_tc", w.dtype))
        dx.copy_(ref.fcnn_layer_dgrad_ref(dy, y, w, _act(act)))


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
