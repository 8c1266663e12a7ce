"""The port's FCNN model, optimizer and training loop against the JAX
reference, from the same numpy parameters and batches.

The reference runs outside any mesh (``shard_constraint`` is then a
no-op), with ``kernel_mode="ref"``; the port runs on the CPU, where its
fused ops use the plain versions.  Tolerances: 5e-6 for the forward,
1e-6 for the loss, 1e-5 for gradients and for the 5-step Adam trajectory.
"""

import jax
import numpy as np
import pytest
import torch

from repro.data import Batcher as JBatcher
from repro.data import fcnn_classification_dataset as j_dataset
from repro.models import fcnn as jfcnn
from repro.optim import adam as j_adam
from repro.optim import linear_warmup_cosine as j_lwc
from repro_torch.launch.train_fcnn import train
from repro_torch.models import fcnn
from repro_torch.optim import adam, linear_warmup_cosine

SIZES = [32, 24, 16, 10]


def _np_params(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return {"layers": [
        {"w": (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
         "b": (rng.normal(size=(b,)) * 0.1).astype(np.float32)}
        for a, b in zip(sizes[:-1], sizes[1:])]}


def _batch(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, SIZES[0])).astype(np.float32),
            rng.integers(0, SIZES[-1], size=n).astype(np.int32))


def _assert_tree_close(ours, theirs, tol):
    for lo, lt in zip(ours["layers"], theirs["layers"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(np.asarray(lo[k]), np.asarray(lt[k]),
                                       rtol=tol, atol=tol, err_msg=k)


def test_params_from_numpy_round_trip():
    tree = _np_params(SIZES)
    params = fcnn.params_from_numpy(tree)
    assert all(t.requires_grad and t.dtype == torch.float32
               for t in fcnn.parameters(params))
    back = fcnn.params_to_numpy(params)
    for lo, lt in zip(back["layers"], tree["layers"]):
        for k in ("w", "b"):
            np.testing.assert_array_equal(lo[k], lt[k])


def test_init_draws_scaled_normals_from_the_generator():
    p1 = fcnn.init(SIZES, torch.Generator().manual_seed(3), "cpu")
    p2 = fcnn.init(SIZES, torch.Generator().manual_seed(3), "cpu")
    for a, b in zip(fcnn.parameters(p1), fcnn.parameters(p2)):
        assert torch.equal(a, b)
    w1 = fcnn.init([4096, 64], torch.Generator().manual_seed(0),
                   "cpu")["layers"][0]["w"]
    assert abs(w1.std().item() * 64 - 1.0) < 0.02   # std is 1/sqrt(4096)


@pytest.mark.parametrize("mode", [None, "ref"])
def test_forward_loss_accuracy_match_reference(mode):
    tree = _np_params(SIZES)
    x, y = _batch(12)
    params = fcnn.params_from_numpy(tree)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    np.testing.assert_allclose(
        fcnn.forward(params, tx, kernel_mode=mode).detach().numpy(),
        np.asarray(jfcnn.forward(tree, x, kernel_mode="ref")),
        rtol=5e-6, atol=5e-6)
    batch = {"x": x, "y": y}
    loss_ref, g_ref = jax.value_and_grad(
        lambda p: jfcnn.loss_fn(p, batch, kernel_mode="ref"))(tree)
    loss = fcnn.loss_fn(params, {"x": tx, "y": ty}, kernel_mode=mode)
    np.testing.assert_allclose(loss.item(), float(loss_ref),
                               rtol=1e-6, atol=1e-6)
    grads = torch.autograd.grad(loss, fcnn.parameters(params))
    it = iter(grads)
    _assert_tree_close({"layers": [{"w": next(it), "b": next(it)}
                                   for _ in tree["layers"]]}, g_ref, 1e-5)
    assert float(fcnn.accuracy(params, tx, ty, kernel_mode=mode)) == float(
        jfcnn.accuracy(tree, x, y, kernel_mode="ref"))


def test_adam_update_matches_reference():
    tree = _np_params(SIZES, seed=4)
    g_tree = _np_params(SIZES, seed=5)
    j_opt = j_adam(j_lwc(3e-3, 2, 5))
    j_params, j_state = tree, j_opt.init(tree)
    opt = adam(linear_warmup_cosine(3e-3, 2, 5))
    params = fcnn.params_from_numpy(tree)
    grads = fcnn.params_from_numpy(g_tree)
    state = opt.init(params)
    for i in range(4):
        j_params, j_state = j_opt.update(g_tree, j_state, j_params, i)
        opt.update(grads, state, params, torch.tensor(float(i)))
    _assert_tree_close(fcnn.params_to_numpy(params), j_params, 1e-6)


def test_five_adam_steps_match_reference_trajectory():
    """The slice end to end: the port's ``train`` against the reference's
    loop (value_and_grad of loss_fn + adam(linear_warmup_cosine)) from the
    same numpy init and the same batches, including a wrap of the data."""
    steps, batch, n = 5, 8, 20
    tree = _np_params(SIZES, seed=6)

    j_opt = j_adam(j_lwc(3e-3, 2, steps))
    j_params, j_state = tree, j_opt.init(tree)
    x, y = j_dataset(n, input_dim=SIZES[0], seed=0)
    j_batches = JBatcher({"x": x, "y": y}, batch_size=batch)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jfcnn.loss_fn(p, b, kernel_mode="ref")))
    j_losses = []
    for i in range(steps):
        loss, g = grad_fn(j_params, next(j_batches))
        j_params, j_state = j_opt.update(g, j_state, j_params, i)
        j_losses.append(float(loss))

    out = train(arch=SIZES, steps=steps, batch=batch, device="cpu",
                params=tree, warmup=2, n_samples=n, log=lambda _: None)
    np.testing.assert_allclose(out["losses"], j_losses, rtol=1e-5, atol=1e-5)
    _assert_tree_close(fcnn.params_to_numpy(out["params"]), j_params, 1e-5)
