"""The port's kernel modules against the JAX reference.

The same numpy inputs go through the JAX kernels (``force="ref"`` and
``force="pallas_interpret"``, outside any mesh, as tests/test_kernels.py
runs them) and through the port's wrappers on CPU tensors, which run the
plain versions.  Tolerances are tests/test_kernels.py's: 5e-6 for the fp32
forward and the direct dgrad/wgrad, 1e-5 for gradients, 1e-6 for the loss,
1e-5 for nll/lse/dlogits.  The CUDA kernels themselves are held against
the plain versions on the card in tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.kernels.fcnn_layer import (
    fcnn_layer_dgrad as j_dgrad,
    fcnn_layer_wgrad as j_wgrad,
)
from repro.kernels.softmax_xent import (
    softmax_xent_dlogits as j_dlogits,
    softmax_xent_fwd as j_xent_fwd,
)
from repro_torch.kernels import ops
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
# aligned, the paper's non-aligned widths (784 in, 10 out, batch 1), ragged
FCNN_SHAPES = [(8, 128, 128), (1, 784, 10), (13, 50, 10)]


def _np(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(ours, theirs, tol, atol=None):
    np.testing.assert_allclose(np.asarray(ours.detach()), np.asarray(theirs),
                               rtol=tol, atol=tol if atol is None else atol)


def _fcnn_inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (_np(rng, (m, k)), _np(rng, (k, n), 0.05), _np(rng, (n,)),
            _np(rng, (m, n)))


@pytest.mark.parametrize("m,k,n", FCNN_SHAPES)
@pytest.mark.parametrize("act", ACTS)
def test_fcnn_plain_versions_match_jax(m, k, n, act):
    """Forward, dgrad and wgrad plain versions against the JAX oracle and
    the Pallas kernels in interpret mode."""
    x, w, b, dy = _fcnn_inputs(m, k, n)
    t = torch.from_numpy

    y_ref = np.array(JR.fcnn_layer_ref(x, w, b, act))
    y_pal = np.asarray(jops.fcnn_layer(x, w, b, act, force="pallas_interpret"))
    y = fcnn_layer(t(x), t(w), t(b), act)
    _close(y, y_ref, 5e-6)
    _close(y, y_pal, 5e-6)

    # backward passes from the same Y, so each is compared on its own
    dx = fcnn_layer_dgrad(t(dy), t(y_ref), t(w), act)
    _close(dx, JR.fcnn_layer_dgrad_ref(dy, y_ref, w, act), 5e-6)
    _close(dx, j_dgrad(dy, y_ref, w, act, interpret=True), 5e-6)

    dw, db = fcnn_layer_wgrad(t(x), t(dy), t(y_ref), act)
    dw_ref, db_ref = JR.fcnn_layer_wgrad_ref(x, dy, y_ref, act)
    dw_pal, db_pal = j_wgrad(x, dy, y_ref, act, interpret=True)
    _close(dw, dw_ref, 5e-6)
    _close(db, db_ref, 5e-6)
    _close(dw, dw_pal, 5e-6)
    _close(db, db_pal, 5e-6)


@pytest.mark.parametrize("b,c", [(1, 10), (64, 10), (37, 300)])
def test_softmax_xent_plain_versions_match_jax(b, c):
    rng = np.random.default_rng(1)
    logits = _np(rng, (b, c), 3.0)
    labels = rng.integers(0, c, size=b).astype(np.int32)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)

    nll, lse, mean = softmax_xent_fwd(tl, tlab)
    nll_pal, lse_pal = j_xent_fwd(logits, labels, interpret=True)
    logp = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    nll_ref = -np.take_along_axis(logp, labels[:, None], 1)[:, 0]
    _close(nll, nll_ref, 1e-5)
    _close(nll, nll_pal, 1e-5)
    _close(lse, lse_pal, 1e-5)
    _close(nll.mean(), JR.softmax_xent_ref(logits, labels), 1e-6)
    _close(mean, JR.softmax_xent_ref(logits, labels), 1e-6)

    g = np.float32(0.7)
    scale = np.full((b,), g / b, np.float32)
    dl = softmax_xent_dlogits(tl, tlab, lse, torch.from_numpy(scale))
    _close(dl, JR.softmax_xent_dlogits_ref(logits, labels, g), 1e-5, 1e-6)
    _close(dl, j_dlogits(logits, labels, np.asarray(lse_pal), scale,
                         interpret=True), 1e-5, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c", [(1, 10), (64, 10), (128, 10), (37, 300)])
def test_softmax_xent_mean_and_cotangent_match_jax(dtype, b, c):
    """K4's batch mean and K5's cotangent form (s = g/B) and per-row form
    with a stride-0 scale, in fp32 and bf16 logits, against the reference's
    kernels in interpret mode and its ``ref`` path.  nll, lse, the mean and
    fp32 dlogits within 1e-5 (the mean 1e-6); bf16 dlogits, which both
    sides round from fp32 values whose exps differ in the last bit, within
    one bf16 ulp (2^-7 of the value) or 1e-6."""
    rng = np.random.default_rng(6)
    logits = jnp.asarray(_np(rng, (b, c), 3.0), getattr(jnp, dtype))
    labels = rng.integers(0, c, size=b).astype(np.int32)
    tl = torch.from_numpy(np.array(logits, np.float32)).to(
        getattr(torch, dtype))
    tlab = torch.from_numpy(labels)

    nll, lse, mean = softmax_xent_fwd(tl, tlab)
    assert (nll.dtype, lse.dtype, mean.dtype, mean.dim()) == (
        torch.float32, torch.float32, torch.float32, 0)
    nll_pal, lse_pal = j_xent_fwd(logits, labels, interpret=True)
    _close(nll, nll_pal, 1e-5)
    _close(lse, lse_pal, 1e-5)
    _close(mean, JR.softmax_xent_ref(logits, labels), 1e-6)

    g = np.float32(0.7)
    want = j_dlogits(logits, labels, lse_pal, jnp.full((b,), g / b),
                     interpret=True)
    bf16_ulp = dict(rtol=2.0 ** -7, atol=1e-6) if dtype == "bfloat16" else {}
    for dl in (softmax_xent_dlogits(tl, tlab, lse, g=torch.tensor(g)),
               softmax_xent_dlogits(tl, tlab, lse,
                                    torch.tensor(g / b).expand(b))):
        assert dl.dtype == tl.dtype
        torch.testing.assert_close(
            dl.float(), torch.from_numpy(np.array(want, np.float32)),
            **(bf16_ulp or dict(rtol=1e-5, atol=1e-6)))
        torch.testing.assert_close(
            dl.float(), torch.from_numpy(np.array(
                JR.softmax_xent_dlogits_ref(logits, labels, g), np.float32)),
            **(bf16_ulp or dict(rtol=1e-5, atol=1e-6)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c", [(1, 10), (37, 300)])
def test_fused_xent_value_and_grad_match_jax_in_both_dtypes(dtype, b, c):
    """``ops.softmax_xent`` (K4's mean, K5 from the cotangent) against
    ``jax.value_and_grad`` of the reference's fused op in interpret mode,
    fp32 and bf16 logits; tolerances as above."""
    rng = np.random.default_rng(7)
    logits = jnp.asarray(_np(rng, (b, c), 3.0), getattr(jnp, dtype))
    labels = rng.integers(0, c, size=b).astype(np.int32)
    loss_ref, g_ref = jax.value_and_grad(
        lambda z: 0.5 * jops.softmax_xent(z, labels,
                                          force="pallas_interpret"))(logits)
    tl = torch.from_numpy(np.array(logits, np.float32)).to(
        getattr(torch, dtype)).requires_grad_(True)
    loss = ops.softmax_xent(tl, torch.from_numpy(labels))
    (0.5 * loss).backward()
    assert loss.dtype == torch.float32 and tl.grad.dtype == tl.dtype
    _close(0.5 * loss, loss_ref, 1e-6)
    tol = (dict(rtol=2.0 ** -7, atol=1e-6) if dtype == "bfloat16"
           else dict(rtol=1e-5, atol=1e-6))
    torch.testing.assert_close(
        tl.grad.float(), torch.from_numpy(np.array(g_ref, np.float32)),
        **tol)


def test_softmax_xent_dlogits_checks_its_factor():
    x, lab = torch.zeros(4, 10), torch.zeros(4, dtype=torch.int32)
    lse = torch.zeros(4)
    with pytest.raises(ValueError, match="exactly one"):
        softmax_xent_dlogits(x, lab, lse)
    with pytest.raises(ValueError, match="exactly one"):
        softmax_xent_dlogits(x, lab, lse, torch.ones(4), g=torch.tensor(1.0))
    with pytest.raises(ValueError, match="0-d"):
        softmax_xent_dlogits(x, lab, lse, g=torch.ones(1))
    with pytest.raises(ValueError, match="stride"):
        softmax_xent_dlogits(x, lab, lse, torch.ones(8)[::2])
    with pytest.raises(TypeError, match="bfloat16"):
        softmax_xent_fwd(x.half(), lab)


@pytest.mark.parametrize("m,k,n", [(16, 784, 24), (3, 20, 10)])
@pytest.mark.parametrize("act", ACTS)
def test_fused_fcnn_grads_match_jax_grad(m, k, n, act):
    """Gradients through ``_FusedFCNN`` (plain bodies on the CPU) against
    ``jax.grad`` of the reference op."""
    x, w, b, tgt = _fcnn_inputs(m, k, n, seed=2)

    def jloss(p):
        y = jops.fcnn_layer(p["x"], p["w"], p["b"], act, force="ref")
        return jnp.mean((y - tgt) ** 2)

    g_ref = jax.grad(jloss)({"x": x, "w": w, "b": b})
    leaves = {k_: torch.from_numpy(v).requires_grad_(True)
              for k_, v in (("x", x), ("w", w), ("b", b))}
    y = ops.fcnn_layer(leaves["x"], leaves["w"], leaves["b"], act)
    ((y - torch.from_numpy(tgt)) ** 2).mean().backward()
    for name in ("x", "w", "b"):
        _close(leaves[name].grad, g_ref[name], 1e-5)


@pytest.mark.parametrize("b,c", [(1, 10), (64, 10), (8, 26)])
def test_fused_xent_loss_and_grad_match_jax(b, c):
    rng = np.random.default_rng(3)
    logits = _np(rng, (b, c), 3.0)
    labels = rng.integers(0, c, size=b).astype(np.int32)
    loss_ref, g_ref = jax.value_and_grad(
        lambda z: jops.softmax_xent(z, labels, force="ref"))(logits)

    tl = torch.from_numpy(logits).requires_grad_(True)
    loss = ops.softmax_xent(tl, torch.from_numpy(labels))
    (0.5 * loss).backward()   # a non-unit cotangent reaches the scale
    _close(loss, loss_ref, 1e-6)
    _close(tl.grad, 0.5 * np.asarray(g_ref), 1e-5, 1e-6)


def test_ref_mode_matches_fused_mode_on_cpu():
    x, w, b, _ = _fcnn_inputs(6, 40, 10, seed=4)
    t = torch.from_numpy
    np.testing.assert_allclose(
        ops.fcnn_layer(t(x), t(w), t(b), "tanh", mode="ref").numpy(),
        ops.fcnn_layer(t(x), t(w), t(b), "tanh").numpy(), rtol=0, atol=0)


def test_dispatch_raises_for_cuda_mode_on_cpu_tensors():
    x, w, b, _ = (torch.from_numpy(a) for a in _fcnn_inputs(4, 8, 10))
    with pytest.raises(ValueError, match="CUDA"):
        ops.fcnn_layer(x, w, b, mode="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.softmax_xent(x, torch.zeros(4, dtype=torch.int32), mode="cuda")
    with pytest.raises(ValueError, match="mode"):
        ops.fcnn_layer(x, w, b, mode="pallas")


def test_wrappers_check_their_arguments():
    x, w, b, _ = (torch.from_numpy(a) for a in _fcnn_inputs(4, 8, 10))
    with pytest.raises(ValueError, match="activation"):
        ops.fcnn_layer(x, w, b, "swish")
    with pytest.raises(TypeError, match="float32"):
        fcnn_layer(x.double(), w, b)
    with pytest.raises(ValueError, match="shape"):
        fcnn_layer(x, w, b[:5])
    with pytest.raises(ValueError, match="contiguous"):
        fcnn_layer(x, w.T.contiguous().T, b)
    with pytest.raises(TypeError, match="int32"):
        softmax_xent_fwd(torch.zeros(4, 10), torch.zeros(4, dtype=torch.int64))


def test_cpu_calls_launch_nothing():
    ops.reset_launches()
    x, w, b, _ = (torch.from_numpy(a) for a in _fcnn_inputs(4, 8, 10))
    x.requires_grad_(True)
    loss = ops.softmax_xent(ops.fcnn_layer(x, w, b, "none"),
                            torch.zeros(4, dtype=torch.int32))
    loss.backward()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("m,k,n,plan", [
    (64, 1000, 500, (8, 32)),    # NN1 layer 2: 32 tiles x 8 = 256 blocks
    (64, 500, 10, (1, 16)),      # NN1 layer 3: one contraction slice
    (1, 784, 10, (1, 16)),
    (64, 784, 1000, (8, 32)),    # 25 tiles x 8 = 200
    (128, 1000, 4000, (4, 32)),  # NN5 layer 3: 64 tiles x 4 = 256
    (128, 4000, 1000, (1, 32)),  # NN5 layer 2: 250 tiles fill the slots
    (1, 16, 4000, (8, 32)),      # one tile: the portable cluster size caps it
])
def test_dgrad_plan_fills_the_card(m, k, n, plan):
    """K2's cluster split and slice width: slices of 32 where n >= 64; the
    largest power-of-two split up to 8 that keeps the grid within two
    blocks per SM of the H100's 132 and every block at >= 2 slices."""
    from repro_torch.kernels.fcnn_layer import dgrad_plan

    split, slice_ = dgrad_plan(m, k, n)
    assert (split, slice_) == plan
    tiles = -(-m // 64) * -(-k // 32)
    assert tiles * split <= max(tiles, 2 * 132)
    assert split == 1 or -(-n // slice_) >= 2 * split


@pytest.mark.parametrize("m,k,n,plan", [
    (64, 784, 1000, (16, 32)),   # NN1 layer 1: 32 tiles x 16 = 512 blocks
    (64, 1000, 500, (16, 32)),   # NN1 layer 2: 16 tiles x 16
    (64, 500, 10, (16, 32)),     # NN1 layer 3: one tile, 16 slices
    (128, 1024, 4000, (2, 32)),  # NN5 layer 1: 250 tiles x 2 = 500
    (128, 4000, 1000, (8, 32)),  # NN5 layer 2: 64 tiles x 8 = 512
    (128, 1000, 4000, (2, 32)),  # NN5 layer 3
    (128, 4000, 10, (16, 32)),   # NN5 layer 4: 2 tiles
    (1, 784, 10, (16, 32)),      # batch 1
    (64, 4000, 32, (16, 32)),    # one tile at K = 4000
    (64, 40, 10, (2, 16)),       # three slices of 16
    (256, 40, 4096, (1, 16)),    # 512 tiles fill the slots
])
def test_fwd_plan_fills_the_card(m, k, n, plan):
    """K1's cluster split and slice width (splitk_plan over 64 x 32 tiles
    of the output (m, n) and the contraction k): the largest power-of-two
    split up to 16 that keeps the grid within four blocks per SM of the
    H100's 132 and every block at >= 1 slice."""
    from repro_torch.kernels.fcnn_layer import (
        FWD_LIMITS,
        fwd_plan,
        splitk_plan,
    )

    split, slice_ = fwd_plan(m, k, n)
    assert (split, slice_) == plan
    tiles = -(-m // 64) * -(-n // 32)
    assert (split, slice_) == splitk_plan(tiles, k, FWD_LIMITS)
    assert tiles * split <= max(tiles, 4 * 132)
    assert split <= -(-k // slice_)


@pytest.mark.parametrize("k,n,tile", [
    (784, 1000, (128, 64)),     # NN1 layer 1: 7 x 16 = 112 tiles of 128 x 64
    (1000, 500, (64, 64)),      # NN1 layer 2: 8 x 8 = 64 of 128 x 64
    (500, 10, (64, 64)),        # NN1 layer 3
    (1024, 4000, (128, 128)),   # NN5 layer 1: 8 x 32 = 256 tiles
    (4000, 1000, (128, 128)),   # NN5 layer 2
    (1000, 4000, (128, 128)),   # NN5 layer 3
    (4000, 10, (64, 64)),       # NN5 layer 4: 32 tiles of 128 x 64
    (12672, 128, (128, 128)),   # 99 x 1 tiles of 128 x 128
    (12544, 128, (128, 64)),    # 98 x 1 of 128 x 128, 98 x 2 of 128 x 64
    (12544, 64, (64, 64)),      # 98 tiles of 128 x 64
])
def test_wgrad_plan_fills_the_card(k, n, tile):
    """K3's dW tile: the largest whose grid holds >= 99 blocks (three in
    four of the H100's 132 SMs), else 64 x 64."""
    from repro_torch.kernels.fcnn_layer import wgrad_plan

    assert wgrad_plan(k, n) == tile
