"""The port's executor against the reference's, on the same programs,
weights and batches.

The oracle is the reference's ``ProgramExecutor`` on the suite's 8 forced
CPU devices (``make_test_mesh(8)``) with ``kernel_mode="ref"``, its
``value_and_grad`` jitted and computed once per module.  Weights come from
the reference's ``fcnn.init`` and batches from
``fcnn_classification_dataset``, handed to the port as numpy arrays.  The
port runs on the CPU, where its kernel wrappers run their plain versions.

Bars (the reference's own, ``tests/test_exec_runtime.py``): loss rtol
1e-6, gradients rtol 1e-4 / atol 1e-7; over 5 Adam steps, losses rtol
1e-5 / atol 1e-6 and parameters rtol 1e-3 / atol 5e-4.  The port sums
each layer's products in another order than XLA (by column chunk, and dX
over the window's partial products), hence tolerances, not bit equality.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.exec as rexec
from repro.configs.nn_benchmarks import onoc_config, workload
from repro.data import fcnn_classification_dataset
from repro.exec.program import compile_fcnn_program as j_compile
from repro.exec.runtime import ProgramExecutor as JExecutor
from repro.launch.mesh import make_test_mesh
from repro.models import fcnn as jfcnn
from repro.optim import adam as j_adam
from repro_torch import exec as pexec
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.models import fcnn
from repro_torch.optim import adam

N_DEV = 8
BATCH = 8
CFG = ONoCConfig(lambda_max=64)
STRATEGIES = ["fm", "rrm", "orrm"]


@functools.lru_cache(maxsize=None)
def _mesh():
    return make_test_mesh(N_DEV)


def _workload(nn):
    return FCNNWorkload(workload(nn).layer_sizes, batch_size=BATCH)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@functools.lru_cache(maxsize=None)
def _params(nn):
    return _np(jfcnn.init(jax.random.PRNGKey(0),
                          workload(nn).layer_sizes))


def _batch(nn, seed=3):
    x, y = fcnn_classification_dataset(
        BATCH, input_dim=workload(nn).layer_sizes[0], seed=seed)
    return x, y


@functools.lru_cache(maxsize=None)
def _oracle(nn, strategy):
    """The reference executor's (loss, full grads, stacked params, stacked
    grads) on ``_params(nn)`` and ``_batch(nn)``."""
    prog = j_compile(workload(nn, batch_size=BATCH), onoc_config(64), N_DEV,
                     strategy)
    x, y = _batch(nn)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    params = jax.tree.map(jnp.asarray, _params(nn))
    rep = JExecutor(prog, _mesh(), kernel_mode="ref")
    loss, grads = jax.jit(jax.value_and_grad(rep.loss_fn))(params, batch)
    sh = JExecutor(prog, _mesh(), kernel_mode="ref", residency="sharded")
    sparams = sh.shard_params(params)
    s_loss, s_grads = jax.jit(jax.value_and_grad(sh.loss_fn))(sparams, batch)
    np.testing.assert_array_equal(np.asarray(loss), np.asarray(s_loss))
    return float(loss), _np(grads), _np(sparams), _np(s_grads)


def _grads(loss, params):
    g = iter(torch.autograd.grad(loss, fcnn.parameters(params)))
    return {"layers": [{"w": next(g).numpy(), "b": next(g).numpy()}
                       for _ in params["layers"]]}


def _assert_trees_close(ours, ref, rtol, atol):
    for lo, lr in zip(ours["layers"], ref["layers"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(lo[k], lr[k], rtol=rtol, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("residency", ["replicated", "sharded"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("nn", ["NN1", "NN2"])
def test_loss_and_grads_match_reference_executor(nn, strategy, residency):
    j_loss, j_grads, j_sparams, j_sgrads = _oracle(nn, strategy)
    exe = pexec.compile(_workload(nn), CFG, N_DEV, strategy=strategy,
                        residency=residency, device="cpu")
    params = fcnn.params_from_numpy(_params(nn))
    if residency == "sharded":
        params = exe.shard_params(params)
        _assert_trees_close(fcnn.params_to_numpy(params), j_sparams, 0, 0)
    x, y = _batch(nn)
    loss = exe.loss_fn(params, {"x": torch.from_numpy(x),
                                "y": torch.from_numpy(y)})
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-6)
    grads = _grads(loss, params)
    if residency == "sharded":
        _assert_trees_close(grads, j_sgrads, 1e-4, 1e-7)
        grads = exe.gather_params(grads)
    _assert_trees_close(grads, j_grads, 1e-4, 1e-7)


@pytest.mark.parametrize("nn", ["NN1", "NN2"])
def test_shard_params_of_numpy_trees_equal_the_reference(nn):
    """Numpy trees convert straight over: the port's stacked layout of
    the reference's weights is the reference's, and gathers back."""
    _, _, j_sparams, _ = _oracle(nn, "orrm")
    exe = pexec.compile(_workload(nn), CFG, N_DEV, device="cpu",
                        analyze="off")
    sp = exe.shard_params(_params(nn))
    assert isinstance(sp["layers"][0]["w"], np.ndarray)
    _assert_trees_close(sp, j_sparams, 0, 0)
    _assert_trees_close(exe.gather_params(sp), _params(nn), 0, 0)


@pytest.mark.parametrize("residency", ["sharded", "replicated"])
def test_five_adam_steps_match_the_reference_facade(residency):
    w = workload("NN1", batch_size=BATCH)
    j_exe = rexec.compile(w, onoc_config(64), _mesh(), strategy="orrm",
                          residency=residency, kernel_mode="ref")
    j_state = j_exe.init_state(jax.random.PRNGKey(0), j_adam(1e-3))
    j_step = j_exe.train_step(j_adam(1e-3), donate=False)
    exe = pexec.compile(_workload("NN1"), CFG, N_DEV, strategy="orrm",
                        residency=residency, device="cpu")
    opt = adam(1e-3)
    state = exe.init_state(None, opt, params=_params("NN1"))
    step = exe.train_step(opt)
    for i in range(5):
        x, y = _batch("NN1", seed=i)
        j_state, j_m = j_step(j_state, {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)})
        state, m = step(state, {"x": torch.from_numpy(x),
                                "y": torch.from_numpy(y)})
        np.testing.assert_allclose(m["loss"].item(), float(j_m["loss"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(j_m["grad_norm"]), rtol=1e-4)
    assert state["step"].item() == int(j_state["step"]) == 5
    ours, ref = state["params"], _np(j_state["params"])
    if residency == "sharded":
        ours, ref = exe.gather_params(ours), j_exe.gather_params(ref)
    # Adam's 1/sqrt(v) amplifies reduction-order noise on near-zero grads
    _assert_trees_close(fcnn.params_to_numpy(ours), _np(ref), 1e-3, 5e-4)
