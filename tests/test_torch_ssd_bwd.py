"""K7's backward (dx, d(dt_a), dB, dC of the SSD intra-chunk term) against
the JAX reference, on the CPU.

The reference has no backward kernel for ``ssd_chunk``: it trains the SSD
by autodiff of its jnp oracle.  So the oracle here is ``jax.vjp`` of
``repro/kernels/ref.py``'s ``ssd_chunk_ref`` (vmapped over chunks, as its
``ops.ssd_chunk`` runs it) and of ``repro/models/mamba2.py``'s
``ssd_chunked``.  The same numpy inputs, made from a seed, go through the
reference and through the port:

  * ``ref.ssd_chunk_bwd_ref`` (the plain backward, which the wrapper runs
    on CPU tensors) with all three cotangents and with each alone, at Q =
    8 to 128, N = 16, 64 and 128, with per-head and broadcast B/C: fp32
    within 1e-5 of each gradient's largest element, dB and dC summed over
    each group's heads; bf16 within one bf16 ulp + 1e-3 of the largest,
    each head's dB and dC (the reference rounds a head's to bf16 before
    the broadcast's transpose sums them, in bf16; the port sums in fp32
    and rounds once, which the autograd test holds to ``mode="ref"``);
  * the port's ``mamba2.ssd_chunked`` through ``ops.ssd_chunk``'s autograd
    function, with and without an initial state, against ``jax.vjp`` of
    the reference's ``ssd_chunked`` (fp32, 1e-5);
  * ``ops.ssd_chunk``'s autograd function against ``mode="ref"``'s
    ordinary autograd;
  * a CPU emulation of the card's bf16 arithmetic (``csrc/ssd_scan_bwd.cu``:
    exact bf16 products summed in fp32, S∘L, ΣdS and dst as bf16 hi + lo,
    a block's heads summed in head order and its parts in block order)
    within chip_smoke.py's phase-7 bars (``k7_bwd_close``) at 1, 2, 4 and
    8 heads a block, where one bf16 rounding of any of the three misses
    them, and d(dt_a)'s bar, floored at ``k7_bwd_noise``, still catches a
    dropped decay term (the pattern of
    ``test_ssd_bf16_kernel_arithmetic_meets_the_card_bars``);
  * ``ssd_bwd_plan`` (a divisor of each group's heads, one wave at the
    training shapes), the wrapper's checks, its meta path (the card's
    scratch, ``cost.ssd_chunk_bwd``), and the launches a remat'd train
    step makes (phase 18's count).

The CUDA kernels are held against the same plain version on the card in
tests/test_torch_kernels_gpu.py and chip_smoke.py's phase 7.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.models import mamba2 as JM
from repro_torch.configs import smoke_config
from repro_torch.core.planner import H100Target
from repro_torch.kernels import cost, ops, ref
from repro_torch.kernels.fcnn_layer import KernelLimitError
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ssd_scan import (SM_COUNT, SSD_BWD_BLOCK_COST,
                                          SSD_BWD_HEADS, bwd_parts_shape,
                                          ssd_bwd_plan, ssd_chunk,
                                          ssd_chunk_bwd)
from repro_torch.launch.steps import TrainSettings, build_train_step, \
    init_train_state
from repro_torch.models import mamba2 as M
from repro_torch.models.api import get_model

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)

FP32_RTOL = 1e-5
BF16_ULP = 2.0 ** -7
BF16_SLACK = 1e-3
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NAMES = ("dx", "ddt", "db", "dc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread beats 8 contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(bc, q, h, p, n, g, seed=0):
    """x (BC, Q, H, P), dt_a (BC, Q, H) = −0.3·|N(0,1)|, b, c (BC, Q, G, N)
    and the cotangents dy, dstate (BC, H, P, N), ddecay: fp32 numpy."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return (normal(bc, q, h, p), -np.abs(normal(bc, q, h)) * 0.3,
            normal(bc, q, g, n), normal(bc, q, g, n), normal(bc, q, h, p),
            normal(bc, h, p, n), normal(bc, q, h))


def _reference_vjp(x, dt_a, b, c, cots, jdt, summed=True):
    """jax.vjp of the vmapped ssd_chunk_ref with B and C repeated from
    their G groups to the H heads, inside the function where ``summed``
    (its transpose sums each group's heads), else outside (each head's
    dB and dC); a None cotangent is zero."""
    h, g = x.shape[2], b.shape[2]
    jb, jc = jnp.asarray(b, jdt), jnp.asarray(c, jdt)
    if not summed:
        jb, jc = jnp.repeat(jb, h // g, axis=2), jnp.repeat(jc, h // g, axis=2)
        g = h

    def f(x, a, b, c):
        return jax.vmap(JR.ssd_chunk_ref)(x, a, jnp.repeat(b, h // g, axis=2),
                                         jnp.repeat(c, h // g, axis=2))

    outs, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(dt_a), jb, jc)
    cot = tuple(jnp.zeros_like(o) if t is None else jnp.asarray(t, o.dtype)
                for o, t in zip(outs, cots))
    return [np.asarray(w, np.float32) for w in vjp(cot)]


def _port_bwd(x, dt_a, b, c, cots, tdt, summed=True):
    """The plain backward on the port's tensors: B and C broadcast from
    their groups (a stride-0 view for one group), as ``ops.ssd_chunk``
    hands them to the wrappers; dB and dC summed over each group where
    ``summed``, else each head's."""
    h = x.shape[2]
    t = [torch.from_numpy(a) for a in (x, dt_a, b, c)]
    dy, dst, dd = (None if a is None else torch.from_numpy(a) for a in cots)
    return ref.ssd_chunk_bwd_ref(
        t[0].to(tdt), t[1], ops.heads_of_groups(t[2].to(tdt), h),
        ops.heads_of_groups(t[3].to(tdt), h),
        None if dy is None else dy.to(tdt), dst, dd,
        b.shape[2] if summed else None)


def _share_of_bar(got, want, dtype) -> float:
    """The worst element of ``got`` as a share of its bar against
    ``want``: fp32 FP32_RTOL of the largest; bf16 one bf16 ulp of |want| +
    BF16_SLACK of the largest."""
    w = np.asarray(want, np.float64)
    d = np.abs(np.asarray(got, np.float64) - w)
    big = np.abs(w).max()
    if big == 0:
        return float(d.max() > 0)
    if dtype == "float32":
        return d.max() / (FP32_RTOL * big)
    return (d / (BF16_ULP * np.abs(w) + BF16_SLACK * big)).max()


# (BC, Q, H, P, N, G): one 128-row chunk at Zamba2's N and mamba2-2.7b's,
# short and ragged chunks, per-head, grouped and broadcast B/C
VJP_SHAPES = [(2, 128, 4, 16, 64, 1), (1, 128, 3, 16, 128, 1),
              (3, 8, 4, 8, 16, 4), (2, 40, 6, 8, 16, 2),
              (2, 77, 2, 32, 64, 2), (2, 100, 4, 8, 128, 4)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", VJP_SHAPES, ids=str)
def test_plain_bwd_matches_reference_vjp(dtype, shape):
    jdt, tdt = DTYPES[dtype]
    x, dt_a, b, c, *cots = _inputs(*shape, seed=sum(shape))
    summed = dtype == "float32"
    want = _reference_vjp(x, dt_a, b, c, cots, jdt, summed)
    got = _port_bwd(x, dt_a, b, c, cots, tdt, summed)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == (torch.float32 if name == "ddt" else tdt)
        assert tuple(g.shape) == w.shape, name
        share = _share_of_bar(g.float().numpy(), w,
                              "float32" if name == "ddt" else dtype)
        assert share <= 1, f"{name}: {share:.2f} of the bar"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("given", ["dy", "dstate", "ddecay", "dy+dstate"])
def test_plain_bwd_with_missing_cotangents(dtype, given):
    """Cotangents left None (outputs autograd did not use) count as zero,
    against the reference's VJP with zeros there."""
    jdt, tdt = DTYPES[dtype]
    x, dt_a, b, c, *cots = _inputs(2, 64, 4, 16, 32, 1, seed=3)
    keep = given.split("+")
    cots = [t if k in keep else None
            for t, k in zip(cots, ("dy", "dstate", "ddecay"))]
    summed = dtype == "float32"
    want = _reference_vjp(x, dt_a, b, c, cots, jdt, summed)
    got = _port_bwd(x, dt_a, b, c, cots, tdt, summed)
    for name, g, w in zip(NAMES, got, want):
        share = _share_of_bar(g.float().numpy(), w,
                              "float32" if name == "ddt" else dtype)
        assert share <= 1, f"{name}: {share:.2f} of the bar"
    if "dy" not in keep:        # dC takes only dS, which needs dy
        assert not got[3].any()


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_autograd_matches_reference_vjp(initial, groups):
    """The port's chunked SSD (K7's autograd function, whose backward is
    the plain backward on the CPU, then the inter-chunk recurrence and the
    readout under ordinary autograd) against ``jax.vjp`` of the
    reference's ``ssd_chunked``: four chunks of 32, fp32, the gradients of
    x, dt_a, B, C and the initial state within 1e-5 of their largest."""
    bs, l, h, p, n, chunk = 2, 128, 4, 8, 16, 32
    rng = np.random.default_rng(9 + groups)
    x = rng.normal(size=(bs, l, h, p)).astype(np.float32)
    dt_a = (-np.abs(rng.normal(size=(bs, l, h))) * 0.3).astype(np.float32)
    b, c = (rng.normal(size=(bs, l, groups, n)).astype(np.float32)
            for _ in range(2))
    s0 = rng.normal(size=(bs, h, p, n)).astype(np.float32)
    dy = rng.normal(size=(bs, l, h, p)).astype(np.float32)
    dfin = rng.normal(size=(bs, h, p, n)).astype(np.float32)
    args = [x, dt_a, b, c] + ([s0] if initial else [])

    def jf(x, a, b, c, *s):
        return JM.ssd_chunked(x, a, b, c, chunk, s[0] if s else None)

    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dy), jnp.asarray(dfin)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    calls = []
    real = ops._ssd_chunk_bwd
    ops_bwd = lambda *a: calls.append(a) or real(*a)  # noqa: E731
    try:
        ops._ssd_chunk_bwd = ops_bwd
        y, fin = M.ssd_chunked(*leaves[:4], chunk,
                               leaves[4] if initial else None)
        got = torch.autograd.grad((y, fin), leaves,
                                  (torch.from_numpy(dy),
                                   torch.from_numpy(dfin)))
    finally:
        ops._ssd_chunk_bwd = real
    assert len(calls) == 1
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert _share_of_bar(g.numpy(), w, "float32") <= 1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_autograd_function_matches_ref_mode(dtype, groups, monkeypatch):
    """``ops.ssd_chunk`` on inputs that require grad: K7 forward (outputs
    equal to ``mode="ref"``'s), one ``ssd_chunk_bwd`` call backward with
    group-shaped B and C, gradients within 1e-5 of ``mode="ref"``'s
    autograd in fp32; in bf16 dx and d(dt_a) within one bf16 ulp + 1e-3
    and 1e-5 of their largest, and dB and dC of a group of heads within
    2^-7 of their norm: the port sums a group's heads in fp32 and rounds
    once, where ``mode="ref"`` rounds each head's dB and dC to bf16 before
    the expand's backward sums them, so an element whose heads cancel
    parts by more than an ulp of itself; no launch on the CPU."""
    jdt, tdt = DTYPES[dtype]
    x, dt_a, b, c, dy, dst, dd = _inputs(2, 48, 4, 8, 16, groups, seed=4)
    calls = []
    real = ops._ssd_chunk_bwd
    monkeypatch.setattr(ops, "_ssd_chunk_bwd",
                        lambda *a: calls.append(a) or real(*a))
    before = ops.launch_counts()
    grads, outs = {}, {}
    for mode in (None, "ref"):
        leaves = [torch.from_numpy(a).to(t).requires_grad_(True)
                  for a, t in ((x, tdt), (dt_a, torch.float32), (b, tdt),
                               (c, tdt))]
        out = ops.ssd_chunk(*leaves, mode=mode)
        outs[mode] = [o.detach() for o in out]
        grads[mode] = torch.autograd.grad(
            out, leaves, (torch.from_numpy(dy).to(tdt), torch.from_numpy(dst),
                          torch.from_numpy(dd)))
    assert len(calls) == 1 and calls[0][-1] == groups
    assert ops.launch_counts() == before
    for a, b_ in zip(outs[None], outs["ref"]):
        assert torch.equal(a, b_)
    for name, g, w in zip(NAMES, grads[None], grads["ref"]):
        assert g.dtype == w.dtype and g.shape == w.shape
        if dtype == "bfloat16" and name in ("db", "dc") and groups < 4:
            gf, wf = g.float(), w.float()
            norm = ((gf - wf).norm() / wf.norm()).item()
            assert norm <= BF16_ULP, f"{name}: {norm:.2e} of the norm"
            continue
        share = _share_of_bar(g.float().numpy(), w.float().numpy(),
                              "float32" if name == "ddt" else dtype)
        assert share <= 1, f"{name}: {share:.2f} of the bar"


def test_no_grad_ssd_calls_the_forward_alone(monkeypatch):
    """Serving (nothing requires grad) calls K7 alone; the raw wrapper keeps
    refusing inputs that require grad."""
    seen = []
    monkeypatch.setattr(ops, "_SsdChunk", None)    # any use would fail
    real = ops._ssd_chunk
    monkeypatch.setattr(ops, "_ssd_chunk",
                        lambda *a: seen.append(a[2].shape) or real(*a))
    x, dt_a, b, c, *_ = (torch.from_numpy(a)
                         for a in _inputs(1, 16, 4, 8, 8, 1))
    ops.ssd_chunk(x, dt_a, b, c)
    with torch.no_grad():
        ops.ssd_chunk(x.requires_grad_(True), dt_a, b, c)
    assert seen == [(1, 16, 4, 8)] * 2          # B broadcast to the heads
    with pytest.raises(RuntimeError, match="forward-only"):
        ssd_chunk(x, dt_a, b.expand(1, 16, 4, 8), c.expand(1, 16, 4, 8))


def test_heads_of_groups_broadcasts_consecutive_heads():
    t = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    h = ops.heads_of_groups(t, 6)
    assert h.shape == (2, 3, 6, 4)
    for head in range(6):
        assert torch.equal(h[:, :, head], t[:, :, head // 3])
    one = ops.heads_of_groups(t[:, :, :1], 6)
    assert one.stride(2) == 0 and one.data_ptr() == t.data_ptr()
    assert ops.heads_of_groups(t, 2) is t
    assert ops.heads_of_groups(t, 5) is t       # the wrapper refuses it


# --------------------------------------------- the card's bf16 arithmetic

def _in_order(t, dim):
    """Σ over ``dim`` one term after another, in index order (the kernel's
    fp32 order: head by head, part by part)."""
    terms = t.unbind(dim)
    out = terms[0]
    for term in terms[1:]:
        out = out + term
    return out


def emulate_bwd(x, dt_a, b, c, dy, dstate, ddecay, groups, once=(),
                drop=(), heads=1):
    """The bf16 kernel's arithmetic (ssd_scan_bwd.cu) in torch: S = C·Bᵀ,
    dM = dy·xᵀ, x·dst and B·dstᵀ as fp32 sums of exact bf16 products; L
    and w from exp in fp32; S∘L and dst entering their products as bf16
    hi + lo, or rounded once to bf16 where named in ``once`` ("w",
    "dst"); d(dt_a) in fp32 from the row and column sums of dS∘S, dw and
    the decay term (left out where ``drop`` names "decay").  A block walks
    ``heads`` consecutive heads of a group: ΣdS over them in fp32, in head
    order, enters dC = ΣdS·B and dB's ΣdSᵀ·C as hi + lo (rounded once
    where ``once`` names "ds"), dB's w∘(x·dst) summed over them in head
    order; each group's parts added in block order; dx, dB and dC rounded
    once."""
    bc, q, h, p = x.shape
    n = b.shape[-1]
    blocks = h // heads

    def operand(v, name):
        hi = v.bfloat16().float()
        return hi if name in once else hi + (v - hi).bfloat16().float()

    xf, bf, cf, dyf = x.float(), b.float(), c.float(), dy.float()
    cs = torch.cumsum(dt_a, 1)
    mask = torch.ones(q, q, dtype=torch.bool).tril()[None, :, :, None]
    lmat = torch.exp((cs[:, :, None] - cs[:, None]).masked_fill(
        ~mask, float("-inf")))
    s = torch.einsum("bthn,bshn->btsh", cf, bf)
    w = torch.exp(cs[:, -1:] - cs)
    ds = torch.einsum("bthp,bshp->btsh", dyf, xf) * lmat
    dst = operand(dstate, "dst")
    dx = (w[..., None] * torch.einsum("bshn,bhpn->bshp", bf, dst)
          + torch.einsum("btsh,bthp->bshp", operand(s * lmat, "w"), dyf))
    f = torch.einsum("bshp,bhpn->bshn", xf, dst)
    sds = operand(_in_order(ds.reshape(bc, q, q, blocks, heads), 4), "ds")
    wf = _in_order((w[..., None] * f).reshape(bc, q, blocks, heads, n), 3)
    bk, ck = bf[:, :, ::heads], cf[:, :, ::heads]   # a block's group's B, C
    db = wf + torch.einsum("btsk,btkn->bskn", sds, ck)
    dc = torch.einsum("btsk,bskn->btkn", sds, bk)
    r = ds * s
    dww = (f * bf).sum(-1) * w
    dcs = r.sum(2) - r.sum(1) - dww
    dcs[:, -1] += dww.sum(1)
    if "decay" not in drop:
        dcs = dcs + ddecay * torch.exp(cs)
    ddt = torch.flip(torch.cumsum(torch.flip(dcs, (1,)), 1), (1,))
    db, dc = (_in_order(t.reshape(bc, q, groups, blocks // groups, n), 3)
              for t in (db, dc))
    return dx.bfloat16(), ddt, db.bfloat16(), dc.bfloat16()


def _card_inputs(shape, seed):
    """bf16 inputs as chip_smoke.py's ``k7_bwd_inputs`` makes them (B and
    C broadcast from their groups), fp32 cotangents of the state and decay."""
    bc, q, h, p, n, g = shape
    x, dt_a, b, c, dy, dst, dd = (torch.from_numpy(a)
                                  for a in _inputs(*shape, seed=seed))
    return (x.bfloat16(), dt_a, ops.heads_of_groups(b.bfloat16(), h),
            ops.heads_of_groups(c.bfloat16(), h), dy.bfloat16(), dst, dd, g)


# Zamba2-1.2B's training shape cut to 2 chunks of 16 heads, mamba2-2.7b's
# N = 128, and per-head B/C at a ragged chunk
EMULATED = {"zamba2": (2, 128, 16, 64, 64, 1),
            "mamba2": (1, 128, 8, 64, 128, 1),
            "per-head": (2, 100, 4, 32, 72, 4)}


def _held(got, want, ins) -> tuple[bool, str]:
    x, _, b, c, dy, dst, dd, _ = ins
    ok, _, crit = SMOKE.k7_bwd_close(torch, got, want,
                                     SMOKE.k7_bwd_noise(x, b, c, dy, dst, dd))
    return ok, crit


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_bf16_kernel_arithmetic_meets_the_card_bars(case):
    """The emulated kernel within chip_smoke.py's phase-7 bars of the plain
    version (``k7_bwd_close``: dx, dB, dC rounded once, d(dt_a) within
    K7_BWD_DT_RTOL of its largest plus its noise floor)."""
    ins = _card_inputs(EMULATED[case], seed=5)
    want = ref.ssd_chunk_bwd_ref(*ins)
    ok, crit = _held(emulate_bwd(*ins), want, ins)
    print(crit)
    assert ok, crit


@pytest.mark.parametrize("operand,misses", [("w", "dx"), ("ds", "db"),
                                            ("ds", "dc"), ("dst", "dx"),
                                            ("dst", "db")])
def test_one_bf16_rounding_misses_the_card_bars(operand, misses):
    """Why the kernel splits S∘L, dS and dst into bf16 hi + lo: rounded
    once to bf16, each puts a gradient it enters past ``rounded_once``
    (tens of percent of its roundings flipped, the hi/lo pair well under
    1%)."""
    ins = _card_inputs(EMULATED["zamba2"], seed=5)
    want = ref.ssd_chunk_bwd_ref(*ins)
    i = NAMES.index(misses)
    ok, note = SMOKE.rounded_once(torch, emulate_bwd(*ins, once=(operand,))[i],
                                  want[i])
    print(f"{operand} rounded once, {misses}: {note}")
    assert not ok, note
    assert SMOKE.rounded_once(torch, emulate_bwd(*ins)[i], want[i])[0]


# every EMULATED case at each heads-per-block choice of 1, 2, 4, 8 that
# divides its group's heads (per-head B/C: 1)
EMULATED_HEADS = [(case, k) for case in sorted(EMULATED) for k in (1, 2, 4, 8)
                  if EMULATED[case][2] // EMULATED[case][5] % k == 0]


@pytest.mark.parametrize("case,heads", EMULATED_HEADS, ids=str)
def test_block_order_of_sums_meets_the_card_bars(case, heads):
    """The emulated kernel with ``heads`` heads a block (ΣdS over them,
    then hi + lo; w∘F summed over them; the parts added in block order)
    within chip_smoke.py's phase-7 bars of the plain version."""
    ins = _card_inputs(EMULATED[case], seed=5)
    want = ref.ssd_chunk_bwd_ref(*ins)
    ok, crit = _held(emulate_bwd(*ins, heads=heads), want, ins)
    print(crit)
    assert ok, crit


@pytest.mark.parametrize("misses", ["db", "dc"])
def test_block_dS_sum_rounded_once_misses_the_card_bars(misses):
    """Why ΣdS over a block's heads enters dB's and dC's products as bf16 hi
    + lo: rounded once to bf16, it puts the gradient past
    ``rounded_once``; hi + lo meets it (8 heads a block at Zamba2's N)."""
    ins = _card_inputs(EMULATED["zamba2"], seed=5)
    want = ref.ssd_chunk_bwd_ref(*ins)
    i = NAMES.index(misses)
    ok, note = SMOKE.rounded_once(
        torch, emulate_bwd(*ins, once=("ds",), heads=8)[i], want[i])
    print(f"ΣdS rounded once, {misses}: {note}")
    assert not ok, note
    assert SMOKE.rounded_once(torch, emulate_bwd(*ins, heads=8)[i],
                              want[i])[0]


def test_ddt_bar_catches_a_dropped_decay_term():
    """d(dt_a)'s bar, floored at the fp32 noise of a summed term
    (``k7_bwd_noise``), still catches a wrong decay: the emulated kernel
    without the decay cotangent's term misses it, by more than ten times
    its margin."""
    ins = _card_inputs(EMULATED["zamba2"], seed=5)
    x, _, b, c, dy, dst, dd, _ = ins
    want = ref.ssd_chunk_bwd_ref(*ins)
    noise = SMOKE.k7_bwd_noise(x, b, c, dy, dst, dd)
    bar = SMOKE.K7_BWD_DT_RTOL * want[1].abs().max().item() + noise
    good = (emulate_bwd(*ins)[1] - want[1]).abs().max().item()
    dropped = emulate_bwd(*ins, drop=("decay",))
    wrong = (dropped[1] - want[1]).abs().max().item()
    print(f"d(dt_a): bar {bar:.3e} (noise floor {noise:.3e}), emulated "
          f"{good:.3e}, decay term dropped {wrong:.3e}")
    assert good <= bar < wrong / 10
    assert not _held(dropped, want, ins)[0]


# ------------------------------------------------ wrapper, meta, cost

def test_bwd_wrapper_checks():
    x, dt_a = torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 4)
    b = torch.zeros(2, 8, 4, 8)
    dst, dd = torch.zeros(2, 4, 16, 8), torch.zeros(2, 8, 4)
    got = ssd_chunk_bwd(x, dt_a, b, b, x, dst, dd)
    assert [tuple(g.shape) for g in got] == [(2, 8, 4, 16), (2, 8, 4),
                                             (2, 8, 4, 8), (2, 8, 4, 8)]
    got = ssd_chunk_bwd(x, dt_a, b, b, None, None, dd, groups=2)
    assert tuple(got[2].shape) == (2, 8, 2, 8) and not got[0].any()
    with pytest.raises(ValueError, match="3 groups do not divide 4 heads"):
        ssd_chunk_bwd(x, dt_a, b, b, x, dst, dd, groups=3)
    with pytest.raises(ValueError, match="dy has shape"):
        ssd_chunk_bwd(x, dt_a, b, b, x[:, :4], dst, dd)
    with pytest.raises(ValueError, match="dstate must be"):
        ssd_chunk_bwd(x, dt_a, b, b, x, dst[..., :4], dd)
    with pytest.raises(ValueError, match="ddecay must be"):
        ssd_chunk_bwd(x, dt_a, b, b, x, dst, dd.bfloat16())
    with pytest.raises(TypeError, match="mixed dtypes"):
        ssd_chunk_bwd(x, dt_a, b, b, x.bfloat16(), dst, dd)
    with pytest.raises(TypeError, match="dt_a must be float32"):
        ssd_chunk_bwd(x, dt_a.double(), b, b, x, dst, dd)
    with pytest.raises(KernelLimitError, match="N <= 128"):
        wide = torch.zeros(2, 8, 4, 130)
        ssd_chunk_bwd(x, dt_a, wide, wide, x, None, None)
    with pytest.raises(RuntimeError, match="forward-only"):
        ssd_chunk_bwd(x.requires_grad_(True), dt_a, b, b, None, None, dd)


class _Recorder:
    def __init__(self):
        self.calls = []

    def kernel(self, name, c):
        self.calls.append((name, c))


def test_meta_path_reports_both_kernels():
    """On meta (the dry-run) ``ops.ssd_chunk`` under autograd reports K7
    and its backward with their costs and returns group-shaped dB and dC,
    in bf16 and fp32; nothing launches."""
    for dtype in (torch.bfloat16, torch.float32):
        meta = dict(device="meta", dtype=dtype)
        e = torch.empty((), dtype=dtype).element_size()
        x = torch.empty(16, 128, 64, 64, **meta).requires_grad_(True)
        dt_a = torch.empty(16, 128, 64, device="meta").requires_grad_(True)
        b = torch.empty(16, 128, 1, 64, **meta).requires_grad_(True)
        c = torch.empty(16, 128, 1, 64, **meta).requires_grad_(True)
        with cost.recording(_Recorder()) as rec:
            y, state, decay = ops.ssd_chunk(x, dt_a, b, c)
            grads = torch.autograd.grad((y, state), (x, dt_a, b, c),
                                        (torch.empty_like(y),
                                         torch.empty_like(state)))
        assert [n for n, _ in rec.calls] == ["ssd_chunk", "ssd_chunk_bwd"]
        assert rec.calls[0][1] == cost.ssd_chunk(16, 128, 64, 64, 64, 1, e)
        assert rec.calls[1][1] == cost.ssd_chunk_bwd(16, 128, 64, 64, 64, 1,
                                                     e)
        assert all(g.is_meta for g in grads)
        assert [tuple(g.shape) for g in grads] == [
            (16, 128, 64, 64), (16, 128, 64), (16, 128, 1, 64),
            (16, 128, 1, 64)]
        assert ops.launch_counts()["ssd_chunk_bwd"] == 0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-2.7b"])
def test_bwd_plan_fills_the_card_at_the_training_shapes(arch):
    """``ssd_bwd_plan`` at phase 7's (and phase 18's) training shapes, one
    B/C group: a divisor of H of SSD_BWD_HEADS whose grid is one wave of
    at least nine in ten of the H100's SMs (8 heads at Zamba2-1.2B, 10 at
    mamba2-2.7b: 128 blocks, where 8 of 80 heads would leave 160, a second
    wave of 28), and no other choice spans less by the plan's measure."""
    bc, q, h, p, n = SMOKE.K7_PATHS[arch]
    heads = ssd_bwd_plan(bc, h, q, 1, n)
    assert heads == {"zamba2-1.2b": 8, "mamba2-2.7b": 10}[arch]
    assert heads in SSD_BWD_HEADS and h % heads == 0
    assert 0.9 * SM_COUNT <= bc * h // heads <= SM_COUNT
    for k in SSD_BWD_HEADS:
        if h % k == 0:
            waves = -(-bc * h // k // SM_COUNT)
            assert waves * (k + SSD_BWD_BLOCK_COST) >= heads + \
                SSD_BWD_BLOCK_COST


@pytest.mark.parametrize("bc,h,g,n", [(16, 64, 1, 64), (16, 80, 1, 128),
                                      (2, 8, 8, 128), (1, 3, 3, 90),
                                      (3, 6, 3, 72), (2, 4, 1, 16),
                                      (2, 8, 2, 4), (32, 64, 1, 64),
                                      (64, 80, 4, 128), (1, 64, 1, 64)])
def test_bwd_plan_keeps_a_block_in_one_group(bc, h, g, n):
    """A block's heads lie in one B/C group: the plan divides H / G (per-head
    B/C, G = H, gives 1, as phase 7's edge cases take it), and a chunk's
    blocks stay within SM_COUNT where some choice allows it."""
    heads = ssd_bwd_plan(bc, h, 128, g, n)
    assert heads in SSD_BWD_HEADS and (h // g) % heads == 0
    if g == h:
        assert heads == 1
    if any((h // g) % k == 0 and bc * h // k <= SM_COUNT
           for k in SSD_BWD_HEADS):
        assert bc * h // heads <= SM_COUNT


def test_bwd_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="chunk 129"):
        ssd_bwd_plan(16, 64, 129, 1)
    with pytest.raises(ValueError, match="state size 129"):
        ssd_bwd_plan(16, 64, 128, 1, 129)
    with pytest.raises(ValueError, match="3 groups do not divide 64"):
        ssd_bwd_plan(16, 64, 128, 3)
    x = torch.zeros(2, 8, 4, 16, dtype=torch.bfloat16)
    b = torch.zeros(2, 8, 4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="3 heads a block"):
        ssd_chunk_bwd(x.to("meta"), torch.zeros(2, 8, 4, device="meta"),
                      b.to("meta"), b.to("meta"), None, None, None, 1,
                      heads=3)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(16, 128, 64, 64, 64, 1),
                                   (16, 128, 80, 64, 128, 1),
                                   (2, 100, 8, 64, 128, 8),
                                   (3, 77, 6, 32, 72, 3)], ids=str)
def test_meta_path_allocates_what_the_card_path_allocates(dtype, shape,
                                                          monkeypatch):
    """On meta (the dry-run) ``ssd_chunk_bwd`` allocates the tensors the
    CUDA path allocates, scratch included (either dtype: one fp32 part of
    dB and dC a block, none where a block is a whole group), and
    reports ``cost.ssd_chunk_bwd``; the CUDA path, run here against a
    stand-in extension, hands the kernel that scratch and the plan's
    heads."""
    bc, q, h, p, n, g = shape
    tdt = DTYPES[dtype][1]
    allocs = {"meta": [], "cuda": []}
    real_empty = torch.empty
    seen = []

    def run(dev):
        x = real_empty(bc, q, h, p, dtype=tdt, device=dev)
        dt_a = real_empty(bc, q, h, device=dev)
        b = real_empty(bc, q, 1, n, dtype=tdt, device=dev).expand(bc, q, h, n)
        dy = real_empty(bc, q, h, p, dtype=tdt, device=dev)
        dst = real_empty(bc, h, p, n, device=dev)
        where = "meta" if dev == "meta" else "cuda"

        def spy(*size, **kw):
            t = real_empty(*size, **kw)
            if t.numel():
                allocs[where].append((tuple(t.shape), t.dtype))
            return t

        monkeypatch.setattr(torch, "empty", spy)
        try:
            return ssd_chunk_bwd(x, dt_a, b, b, dy, dst, None, g)
        finally:
            monkeypatch.setattr(torch, "empty", real_empty)

    with cost.recording(_Recorder()) as rec:
        run("meta")
    assert rec.calls == [("ssd_chunk_bwd", cost.ssd_chunk_bwd(
        bc, q, h, p, n, g, 2 if dtype == "bfloat16" else 4))]
    monkeypatch.setattr(ssd_scan, "device_type", lambda *a: "cuda")
    monkeypatch.setattr(ssd_scan._build, "extension", lambda: SimpleNamespace(
        ssd_chunk_bwd=lambda *a: seen.append(a)))
    run("cpu")
    assert allocs["meta"] == allocs["cuda"]
    heads = ssd_bwd_plan(bc, h, q, g, n)
    want = bwd_parts_shape(bc, q, h, n, g, heads)
    (args,) = seen
    assert args[-1] == heads and tuple(args[9].shape) == want
    parts = h // heads
    assert want == ((0,) if parts == g else (2, bc, q, parts, n))
    if shape[:3] == (16, 128, 64):     # Zamba2-1.2B: 8 parts of 64
        assert want == (2, 16, 128, 8, 64)


def test_bwd_cost_and_bound_at_zamba2():
    """Per (chunk, head) five products over the kept pairs (S, dM, (S∘L)ᵀ·dy
    at P, dS·B and dSᵀ·C at N: pairs·(6N + 4P)) and two over the chunk's
    rows (B·dstᵀ, x·dst: 4QPN); bytes: x, dy, dx at H heads, B, C, dB, dC
    at G groups, dst, dt_a, ddecay and d(dt_a) in fp32: 69.7 MB and a
    0.02082 ms byte bound at Zamba2-1.2B's training shape (16 chunks of
    128, 64 heads of 64, N = 64, one group) in bf16 (7.6 GFLOP, 0.0076 ms
    at the bf16 peak), 108.9 MB and 0.03251 ms at mamba2-2.7b's.  In fp32
    the products run as three TF32 products each (3xTF32): 0.04581 ms at
    the TF32 peak against 0.03615 ms of bytes at Zamba2-1.2B's shape."""
    bc, q, h, p, n = 16, 128, 64, 64, 64
    c = cost.ssd_chunk_bwd(bc, q, h, p, n, 1, 2)
    pairs = q * (q + 1) // 2
    assert c.flops == {"bfloat16": bc * h * (pairs * (6 * n + 4 * p)
                                             + 4 * q * p * n)}
    assert c.nbytes == (3 * bc * q * h * p * 2 + 4 * bc * q * n * 2
                        + bc * h * p * n * 4 + 3 * bc * q * h * 4)
    ops_s, bytes_s = c.seconds(H100Target())
    assert bytes_s > ops_s and round(bytes_s * 1e3, 5) == 0.02082
    m = cost.ssd_chunk_bwd(16, 128, 80, 64, 128, 1, 2)
    assert round(m.seconds(H100Target())[1] * 1e3, 5) == 0.03251
    f32 = cost.ssd_chunk_bwd(bc, q, h, p, n, 1, 4)
    assert f32.flops == {"tfloat32": 3 * c.flops["bfloat16"]}
    assert [round(t * 1e3, 5) for t in f32.seconds(H100Target())] == [
        0.04581, 0.03615]


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_train_step_launches_match_phase_18(family, monkeypatch):
    """A remat'd smoke train step calls K7 twice a Mamba2 layer and
    microbatch (the recompute) and its backward once, as
    ``chip_smoke.train_launches`` (phase 18's expectation) counts them; the
    CPU step launches nothing."""
    arch = {"ssm": "mamba2-2.7b", "hybrid": "zamba2-1.2b"}[family]
    cfg = smoke_config(arch).replace(remat=True)
    model = get_model(cfg)
    calls = dict.fromkeys(("ssd_chunk", "ssd_chunk_bwd"), 0)
    for attr, name in (("_ssd_chunk", "ssd_chunk"),
                       ("_ssd_chunk_bwd", "ssd_chunk_bwd")):
        real = getattr(ops, attr)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, attr, spy)
    settings = TrainSettings(microbatches=2)
    state = init_train_state(model, settings, torch.Generator().manual_seed(0),
                             "cpu")
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 33),
                                        dtype=np.int32))
    before = ops.launch_counts()
    build_train_step(model, settings)(state, {"tokens": tok[:, :-1],
                                              "labels": tok[:, 1:]})
    want = SMOKE.train_launches(cfg, 2, True)
    assert calls == {k: want[k] for k in calls}
    assert calls["ssd_chunk"] == 2 * calls["ssd_chunk_bwd"] == \
        4 * cfg.n_layers
    assert ops.launch_counts() == before
