"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every case is marked ``gpu`` and skips where there is no CUDA
device; the file imports no jax, so it runs on a machine without it:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: 1e-4 relative to the largest output for the GEMMs (fp32 sums
of up to 4000 terms taken in another order than cuBLAS's), 1e-5 for
nll/lse/dlogits.
"""

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


@pytest.mark.gpu
@pytest.mark.parametrize("b,c", [(1, 10), (64, 10), (37, 300)])
def test_softmax_xent_kernels_match_plain_on_card(cuda, b, c):
    rng = np.random.default_rng(5)
    logits = _rand(rng, (b, c), cuda, 3.0)
    labels = torch.from_numpy(
        rng.integers(0, c, size=b).astype(np.int32)).to(cuda)
    scale = torch.full((b,), 0.7 / b, device=cuda)
    nll, lse = softmax_xent_fwd(logits, labels)
    dl = softmax_xent_dlogits(logits, labels, lse, scale)
    torch.cuda.synchronize()
    nll_r, lse_r = ref.softmax_xent_fwd_ref(logits, labels)
    torch.testing.assert_close(nll, nll_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, lse_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        dl, ref.softmax_xent_dlogits_ref(logits, labels, lse, scale),
        rtol=1e-5, atol=1e-5)


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
                      "softmax_xent_dlogits": 1}
    loss_r = ops.softmax_xent(ops.fcnn_layer(x, w, b, "none", mode="ref"), y,
                              mode="ref")
    gw_r, gb_r = torch.autograd.grad(loss_r, [w, b])
    torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=1e-5)
    _assert_rel(gw, gw_r, 1e-4)
    _assert_rel(gb, gb_r, 1e-4)
