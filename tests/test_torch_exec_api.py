"""The port's executor and façade inside torch, on the CPU: sharded
residency against replicated bit for bit (losses, gradients, 5 Adam
steps), off-window slots that stay exactly zero, the kernel calls each
period makes (only window devices launch), the error paths and
``degrade``.  Full-width NN1/NN2 at batch 8 on an 8-device ring."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import exec as pexec
from repro_torch.configs.nn_benchmarks import NN_BENCHMARKS
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.data import fcnn_classification_dataset
from repro_torch.exec import runtime
from repro_torch.exec.program import compile_fcnn_program
from repro_torch.exec.residency import ResidencyTracker
from repro_torch.models import fcnn
from repro_torch.optim import adam, global_norm

N_DEV = 8
BATCH = 8
CFG = ONoCConfig(lambda_max=64)
STRATEGIES = ["fm", "rrm", "orrm"]


def _workload(nn="NN1"):
    return FCNNWorkload(NN_BENCHMARKS[nn], batch_size=BATCH)


def _compile(nn="NN1", **kw):
    kw.setdefault("device", "cpu")
    return pexec.compile(_workload(nn), CFG, N_DEV, **kw)


def _batch(nn="NN1", seed=3):
    x, y = fcnn_classification_dataset(
        BATCH, input_dim=NN_BENCHMARKS[nn][0], seed=seed)
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def _params(nn="NN1", seed=0):
    return fcnn.init(NN_BENCHMARKS[nn], torch.Generator().manual_seed(seed),
                     "cpu")


def _loss_and_grads(exe, params, batch):
    loss = exe.loss_fn(params, batch)
    return loss, torch.autograd.grad(loss, fcnn.parameters(params))


def _tree(flat):
    it = iter(flat)
    return {"layers": [{"w": next(it), "b": next(it)}
                       for _ in range(len(flat) // 2)]}


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(fcnn.parameters(a), fcnn.parameters(b)))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("nn", ["NN1", "NN2"])
def test_sharded_equals_replicated_bit_for_bit(nn, strategy):
    rep = _compile(nn, strategy=strategy, residency="replicated")
    sh = _compile(nn, strategy=strategy, residency="sharded")
    params, batch = _params(nn), _batch(nn)
    loss_r, g_r = _loss_and_grads(rep, params, batch)
    sp = sh.shard_params(params)
    loss_s, g_s = _loss_and_grads(sh, sp, batch)
    assert torch.equal(loss_r, loss_s)
    # stacked gradients: every off-window slot is an exact zero, never None
    for lay, gw, gb in zip(sh.executor._layout, g_s[0::2], g_s[1::2]):
        off = [s for s, c in enumerate(lay.owner_chunk) if c is None]
        assert not gw[off].any() and not gb[off].any()
    assert _equal(sh.gather_params(_tree(g_s)), _tree(g_r))


def test_five_adam_steps_sharded_equal_replicated():
    opt = adam(1e-3)
    exes = {r: _compile(residency=r) for r in ("sharded", "replicated")}
    states = {r: e.init_state(torch.Generator().manual_seed(0), opt)
              for r, e in exes.items()}
    steps = {r: e.train_step(opt) for r, e in exes.items()}
    for i in range(5):
        batch = _batch(seed=i)
        losses = {r: steps[r](states[r], batch)[1]["loss"] for r in exes}
        assert torch.equal(losses["sharded"], losses["replicated"])
    assert _equal(exes["sharded"].gather_params(states["sharded"]["params"]),
                  states["replicated"]["params"])


def test_off_window_slots_stay_exactly_zero():
    exe = _compile(residency="sharded")
    opt = adam(1e-2)
    state = exe.init_state(torch.Generator().manual_seed(0), opt)
    step = exe.train_step(opt)
    for i in range(3):
        state, _ = step(state, _batch(seed=i))
    n_off = 0
    for lay, lp in zip(exe.executor._layout, state["params"]["layers"]):
        for s, c in enumerate(lay.owner_chunk):
            if c is None:
                n_off += 1
                assert not lp["w"][s].any() and not lp["b"][s].any()
            else:
                assert lp["w"][s].any()
    assert n_off == 4 + 6    # NN1 ORRM: windows of 8, 4 and 2 devices


def test_shard_gather_round_trip():
    exe = _compile(residency="sharded")
    params = _params(seed=7)
    sp = exe.shard_params(params)
    assert all(t.requires_grad for t in fcnn.parameters(sp))
    assert tuple(sp["layers"][1]["w"].shape) == (N_DEV, 1000, 125)
    assert _equal(exe.gather_params(sp), params)
    tree = fcnn.params_to_numpy(params)
    back = exe.gather_params(exe.shard_params(tree))
    for lo, lt in zip(back["layers"], tree["layers"]):
        for k in ("w", "b"):
            np.testing.assert_array_equal(lo[k], lt[k])


def test_strategies_compute_the_same_function():
    params, batch = _params(), _batch()
    losses = [_compile(strategy=s, residency="replicated").loss_fn(
        params, batch).item() for s in STRATEGIES]
    assert losses[0] == pytest.approx(losses[1], rel=1e-7)
    assert losses[0] == pytest.approx(losses[2], rel=1e-7)


def test_executor_matches_the_single_device_path():
    params, batch = _params(), _batch()
    loss_1, g_1 = _loss_and_grads(_compile(residency="replicated"), params,
                                  batch)
    loss = fcnn.loss_fn(params, batch)
    g = torch.autograd.grad(loss, fcnn.parameters(params))
    np.testing.assert_allclose(loss_1.item(), loss.item(), rtol=1e-6)
    for a, b in zip(g_1, g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-7)


@pytest.mark.parametrize("residency", ["sharded", "replicated"])
def test_only_window_devices_call_the_kernels(residency, monkeypatch):
    """K1 runs once per window device and period (sum of the degrees, 14
    for NN1 ORRM on 8 devices), K3 as often, K2 only at layers 2..l (4 +
    2), and the loss period calls K4/K5 once each."""
    calls = {"fwd": 0, "dgrad": 0, "wgrad": 0, "xent_fwd": 0,
             "xent_dlogits": 0}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    fns = runtime._KERNEL_FNS
    monkeypatch.setattr(runtime, "_KERNEL_FNS", tuple(
        counted(k, f) for k, f in zip(("fwd", "dgrad", "wgrad"), fns)))
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "_xent_fwd", counted("xent_fwd", ops._xent_fwd))
    monkeypatch.setattr(ops, "_xent_dlogits",
                        counted("xent_dlogits", ops._xent_dlogits))
    exe = _compile(residency=residency)
    assert exe.program.degrees == (8, 4, 2)
    params = _params()
    if residency == "sharded":
        params = exe.shard_params(params)
    _loss_and_grads(exe, params, _batch())
    assert calls == {"fwd": 14, "dgrad": 6, "wgrad": 14, "xent_fwd": 1,
                     "xent_dlogits": 1}


def test_degrade_switches_the_mode_and_changes_nothing_on_cpu():
    exe = _compile(residency="sharded")
    sp, batch = exe.shard_params(_params()), _batch()
    loss, grads = _loss_and_grads(exe, sp, batch)
    assert exe.kernel_mode is None
    assert exe.degrade("ref") is None
    assert exe.kernel_mode == "ref" == exe.executor.kernel_mode
    loss_r, grads_r = _loss_and_grads(exe, sp, batch)
    assert torch.equal(loss, loss_r)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))
    assert exe.degrade(None) == "ref"
    with pytest.raises(ValueError, match="unknown kernel mode"):
        exe.degrade("pallas")


def test_cuda_mode_refuses_host_tensors():
    exe = _compile(kernel_mode="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        exe.loss_fn(exe.shard_params(_params()), _batch())


def test_train_step_clips_by_global_norm():
    exe = _compile(residency="sharded")
    state = exe.init_state(torch.Generator().manual_seed(0), adam(0.0))
    batch = _batch()
    _, grads = _loss_and_grads(exe, state["params"], batch)
    want = global_norm(list(grads))
    before = [t.clone() for t in fcnn.parameters(state["params"])]
    state, m = exe.train_step(adam(0.0), grad_clip=0.1)(state, batch)
    assert torch.equal(m["grad_norm"], want) and want.item() > 0.1
    assert all(torch.equal(a, b) for a, b in
               zip(before, fcnn.parameters(state["params"])))  # lr 0


def test_facade_surface():
    exe = _compile("NN2", strategy="rrm", residency="sharded")
    assert isinstance(exe, pexec.Executable)
    assert exe.program.version == 2 and exe.program.strategy == "rrm"
    assert exe.residency == "sharded" and exe.device == torch.device("cpu")
    assert exe.tracker.peak_ratio() < 1.0
    assert exe.tracker.timeline() == ResidencyTracker(
        exe.program, mode="sharded").timeline()
    state = exe.init_state(torch.Generator().manual_seed(0), adam(1e-3))
    assert state["step"].dtype == torch.float32
    assert tuple(state["opt"]["m"]["layers"][0]["w"].shape) == (
        N_DEV, 784, 375)
    prog = exe.program
    again = pexec.Executable.from_program(
        pexec.PeriodProgram.from_json(prog.to_json()), residency="replicated",
        device="cpu", workload=_workload("NN2"), cfg=CFG, analyze="full")
    assert again.program == prog and again.residency == "replicated"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = compile_fcnn_program(_workload(), CFG, N_DEV)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pexec.compile(_workload(), CFG, N_DEV)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pexec.ProgramExecutor(prog)


def test_error_paths():
    prog = compile_fcnn_program(_workload(), CFG, N_DEV)
    with pytest.raises(ValueError, match="residency"):
        _compile(residency="holographic")
    with pytest.raises(ValueError, match="n_devices >= 1"):
        pexec.compile(_workload(), CFG, 0, device="cpu")
    v1 = dataclasses.replace(prog, version=1)
    with pytest.raises(ValueError, match="schema-v2"):
        pexec.ProgramExecutor(v1, device="cpu", residency="sharded")
    pexec.ProgramExecutor(v1, device="cpu")      # replicated still runs
    with pytest.raises(ValueError, match="analyze level"):
        _compile(analyze="everything")

    exe = _compile(residency="sharded")
    # a ring of another size: weights stacked for 4 devices
    four = pexec.ProgramExecutor(
        compile_fcnn_program(_workload(), CFG, 4), device="cpu",
        residency="sharded")
    with pytest.raises(ValueError, match="compiled for 8 devices"):
        exe.loss_fn(four.shard_params(_params()), _batch())
    sp = exe.shard_params(_params())
    with pytest.raises(ValueError, match="program has 3 layers"):
        exe.loss_fn({"layers": sp["layers"][:2]}, _batch())
    with pytest.raises(ValueError, match="full-layout shape"):
        exe.shard_params(fcnn.init([784, 64, 32, 10],
                                   torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(ValueError, match="sharded-layout shape"):
        exe.loss_fn(_params(), _batch())      # full layout, sharded executor
    bad = exe.shard_params(_params())
    bad["layers"][2]["b"] = torch.zeros(N_DEV, 4)
    with pytest.raises(ValueError, match="bias shape"):
        exe.loss_fn(bad, _batch())
