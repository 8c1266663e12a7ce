"""The port's degraded-mode runner (``repro_torch.runtime.degraded``)
against the reference's, on the same schedules, weights and batches.

The oracle is the reference's ``DegradedModeRunner`` on the suite's 8
forced CPU devices with ``kernel_mode="ref"``, run once per scenario and
module.  The scenarios are the seven of the reference's
``tests/test_fault_recovery.py`` and a device loss at step 1 with a
checkpoint every 4 steps, after one in-place update and before the first
checkpoint.  The port runs on the CPU, where its kernel wrappers run
their plain versions.

Bars: against the reference, per-step losses rtol 1e-5 / atol 1e-6 and
final params rtol 1e-3 / atol 5e-4 (the port sums each layer by column
chunk, in another order than XLA), and every ``FaultReport`` field
exactly equal.  Within the port, the reference's own bars for a resumed
run against a from-scratch run on the survivors (losses rtol 1e-4 / atol
1e-6), bit for bit where the resumed run restarted from the initial
state, and sharded against replicated recovery bit for bit.
"""

import dataclasses
import functools
import logging
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs.nn_benchmarks import onoc_config
from repro.core.onoc_model import FCNNWorkload as JWorkload
from repro.data import Batcher as JBatcher
from repro.models import fcnn as jfcnn
from repro.optim import adam as j_adam
from repro.runtime import faults as jf
from repro.runtime.degraded import DegradedModeRunner as JRunner
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.data import Batcher, fcnn_classification_dataset
from repro_torch.exec import runtime as pruntime
from repro_torch.launch import elastic_restart
from repro_torch.models import fcnn
from repro_torch.optim import adam
from repro_torch.runtime import DegradedModeRunner, faults
from repro_torch.runtime.elastic import ElasticPlanner

SIZES = [32, 16, 8, 10]
BATCH = 8
N_STEPS = 8
N_DEV = 8
X, Y = fcnn_classification_dataset(64, input_dim=SIZES[0], seed=3)


def _events(mod, name):
    K, E = mod.FaultKind, mod.FaultEvent
    if name == "seeded":
        return mod.FaultSchedule.seeded_device_loss(
            0, n_steps=N_STEPS, n_devices=N_DEV, n_periods=6)
    return mod.FaultSchedule(events={
        "none": (),
        "loss_8_to_6": (E(kind=K.DEVICE_LOSS, step=4, period=2, device=6),
                        E(kind=K.DEVICE_LOSS, step=4, period=2, device=7)),
        "loss_step_0": (E(kind=K.DEVICE_LOSS, step=0, period=1, device=7),),
        "loss_step_1": (E(kind=K.DEVICE_LOSS, step=1, period=2, device=7),),
        "transient": (E(kind=K.TRANSIENT_RUN, step=2, period=1, device=0,
                        count=2),),
        "straggler": (E(kind=K.STRAGGLER, step=1, period=2, magnitude=2.0),
                      E(kind=K.WAVELENGTH_DEGRADE, step=2, period=1,
                        magnitude=0.5)),
    }[name])


# name: (schedule, devices, kernel mode (port, reference), residency,
#        steps, checkpoint every)
SCENARIOS = {
    "device_loss_replan_resume": ("loss_8_to_6", 8, (None, None),
                                  "replicated", 8, 2),
    "seeded_device_loss": ("seeded", 8, (None, None), "replicated", 8, 2),
    "loss_before_first_checkpoint": ("loss_step_0", 8, (None, None),
                                     "replicated", 8, 2),
    "transient_retried": ("transient", 8, (None, None), "replicated", 8, 2),
    "kernel_failure_degrades": ("none", 8, ("cuda", "pallas"), "replicated",
                                3, 2),
    "sharded_recovery": ("loss_8_to_6", 8, (None, None), "sharded", 8, 2),
    "straggler_and_degrade": ("straggler", 8, (None, None), "replicated", 8,
                              2),
    "loss_after_an_update": ("loss_step_1", 8, (None, None), "sharded", 8, 4),
}


@functools.lru_cache(maxsize=None)
def _params_np():
    return jax.tree.map(np.asarray, jfcnn.init(jax.random.PRNGKey(0), SIZES))


@functools.lru_cache(maxsize=None)
def _ref(scenario):
    """The reference runner's (losses, final params, report, final step)."""
    sched, n, (_, mode), residency, n_steps, every = SCENARIOS[scenario]
    params0 = jax.tree.map(jax.numpy.asarray, _params_np())
    opt = j_adam(1e-2)
    with tempfile.TemporaryDirectory() as tmp:
        runner = JRunner(
            workload=JWorkload(SIZES, batch_size=BATCH),
            base_cfg=dataclasses.replace(onoc_config(64), m=n),
            schedule=_events(jf, sched), checkpointer=JCheckpointer(tmp),
            optimizer=opt, n_devices=n, kernel_mode=mode or "ref",
            residency=residency, checkpoint_every=every, backoff_s=0.0)
        state, _, report = runner.run(
            params0, opt.init(params0),
            JBatcher({"x": X, "y": Y}, batch_size=BATCH), n_steps)
    return (dict(runner.losses), jax.tree.map(np.asarray, state["params"]),
            report.to_dict(), int(state["step"]))


def _port(sched, n, mode=None, residency="replicated", n_steps=N_STEPS,
          every=2, params=None):
    params0 = fcnn.params_from_numpy(params or _params_np(), "cpu")
    opt = adam(1e-2)
    with tempfile.TemporaryDirectory() as tmp:
        runner = DegradedModeRunner(
            workload=FCNNWorkload(SIZES, batch_size=BATCH),
            base_cfg=ONoCConfig(m=n, lambda_max=64),
            schedule=_events(faults, sched), checkpointer=Checkpointer(tmp),
            optimizer=opt, n_devices=n, kernel_mode=mode, residency=residency,
            checkpoint_every=every, backoff_s=0.0, device="cpu")
        state, history, report = runner.run(
            params0, opt.init(params0),
            Batcher({"x": X, "y": Y}, batch_size=BATCH, device="cpu"),
            n_steps)
    return runner, state, history, report


def _params(state):
    return [t.detach().numpy() for t in fcnn.parameters(state["params"])]


def _ref_params(tree):
    return [lp[k] for lp in tree["layers"] for k in ("w", "b")]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_runner_matches_the_reference(scenario):
    sched, n, (mode, _), residency, n_steps, every = SCENARIOS[scenario]
    runner, state, history, report = _port(sched, n, mode, residency,
                                           n_steps, every)
    ref_losses, ref_params, ref_report, ref_step = _ref(scenario)

    assert report.to_dict() == ref_report
    assert int(state["step"]) == ref_step == n_steps
    losses = runner.losses
    assert sorted(losses) == sorted(ref_losses) == list(range(n_steps))
    for s in range(n_steps):
        np.testing.assert_allclose(losses[s], ref_losses[s], rtol=1e-5,
                                   atol=1e-6)
    for a, b in zip(_params(state), _ref_params(ref_params)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=5e-4)
    assert [h["step"] for h in history][-1] == n_steps - 1


@pytest.mark.parametrize("residency", ["replicated", "sharded"])
def test_resumed_run_matches_from_scratch_on_the_survivors(residency):
    """8 -> 6 devices at step 4, resumed from the checkpoint of step 3."""
    runner, state, _, report = _port("loss_8_to_6", N_DEV,
                                     residency=residency)
    assert report.resumed_from == [3]
    rp = report.replans[0]
    assert (rp["from_devices"], rp["to_devices"], rp["lost"]) == (8, 6, [6, 7])
    assert runner.program.n_devices == 6
    assert runner.executable.residency == residency
    scratch, state2, _, report2 = _port("none", 6, residency=residency)
    assert report2.replans == []
    for s in range(N_STEPS):
        np.testing.assert_allclose(runner.losses[s], scratch.losses[s],
                                   rtol=1e-4, atol=1e-6)
    for a, b in zip(_params(state), _params(state2)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=5e-4)


@pytest.mark.parametrize("sched,every", [("loss_step_0", 2),
                                         ("loss_step_1", 4)])
@pytest.mark.parametrize("residency", ["replicated", "sharded"])
def test_restart_without_a_checkpoint_is_a_from_scratch_run(sched, every,
                                                            residency):
    """A device lost before the first checkpoint: the run restarts on the
    survivors from the initial state and data position, so it is the
    from-scratch run bit for bit, even after a step that updated the
    state in place (step 1)."""
    runner, state, _, report = _port(sched, N_DEV, residency=residency,
                                     every=every)
    assert report.resumed_from == [-1]
    scratch, state2, _, _ = _port("none", 7, residency=residency,
                                  every=every)
    assert runner.losses == scratch.losses
    for a, b in zip(_params(state), _params(state2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sched", ["loss_8_to_6", "seeded", "loss_step_1"])
def test_sharded_recovery_equals_replicated(sched):
    sharded, state_s, _, rep_s = _port(sched, N_DEV, residency="sharded")
    repl, state_r, _, rep_r = _port(sched, N_DEV, residency="replicated")
    assert rep_s.to_dict() == rep_r.to_dict()
    assert sharded.losses == repl.losses
    for a, b in zip(_params(state_s), _params(state_r)):
        np.testing.assert_array_equal(a, b)
    for k in ("m", "v"):
        for a, b in zip(fcnn.parameters(state_s["opt_state"][k]),
                        fcnn.parameters(state_r["opt_state"][k])):
            assert torch.equal(a, b)


def test_run_leaves_the_callers_state_untouched():
    params0 = fcnn.params_from_numpy(_params_np(), "cpu")
    opt = adam(1e-2)
    opt0 = opt.init(params0)
    before = [t.detach().clone() for t in fcnn.parameters(params0)]
    with tempfile.TemporaryDirectory() as tmp:
        DegradedModeRunner(
            workload=FCNNWorkload(SIZES, batch_size=BATCH),
            base_cfg=ONoCConfig(m=8, lambda_max=64),
            schedule=_events(faults, "loss_step_1"),
            checkpointer=Checkpointer(tmp), optimizer=opt, n_devices=8,
            residency="sharded", backoff_s=0.0, device="cpu",
        ).run(params0, opt0, Batcher({"x": X, "y": Y}, BATCH, "cpu"), 4)
    assert all(torch.equal(a, b)
               for a, b in zip(fcnn.parameters(params0), before))
    assert all(not t.any() for k in ("m", "v")
               for t in fcnn.parameters(opt0[k]))


def test_kernel_failure_is_an_explicit_logged_switch(caplog):
    with caplog.at_level(logging.WARNING, logger="repro_torch.runtime"):
        runner, state, _, report = _port("none", N_DEV, mode="cuda",
                                         n_steps=3)
    assert report.kernel_fallbacks == 1
    assert runner.executor.kernel_mode == "ref"
    assert "degrades to kernel_mode='ref'" in caplog.text
    scratch, _, _, _ = _port("none", N_DEV, mode="ref", n_steps=3)
    assert runner.losses == scratch.losses


def test_cuda_errors_are_not_degraded(monkeypatch):
    """On the card the runner never falls back to the plain versions: it
    re-raises every failure that is not a scheduled fault, whatever its
    type or text.  On the CPU a failure of the plain path is re-raised."""
    def broken(self, params, batch):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(pruntime.ProgramExecutor, "loss_fn", broken)
    params0 = fcnn.params_from_numpy(_params_np(), "cpu")
    opt = adam(1e-2)
    with tempfile.TemporaryDirectory() as tmp:
        runner = DegradedModeRunner(
            workload=FCNNWorkload(SIZES, batch_size=BATCH),
            base_cfg=ONoCConfig(m=8, lambda_max=64),
            schedule=_events(faults, "none"), checkpointer=Checkpointer(tmp),
            optimizer=opt, n_devices=8, kernel_mode="ref", max_retries=0,
            backoff_s=0.0, device="cpu")
        with pytest.raises(RuntimeError, match="illegal memory access"):
            runner.run(params0, opt.init(params0),
                       Batcher({"x": X, "y": Y}, BATCH, "cpu"), 2)
    assert runner.report.kernel_fallbacks == 0

    with tempfile.TemporaryDirectory() as tmp:
        runner = DegradedModeRunner(
            workload=FCNNWorkload(SIZES, batch_size=BATCH),
            base_cfg=ONoCConfig(m=8, lambda_max=64),
            schedule=_events(faults, "none"), checkpointer=Checkpointer(tmp),
            optimizer=opt, n_devices=8, device="cpu")
        runner._build(8)
    runner.device = torch.device("cuda", 0)   # the fallback reads its type
    for e in (RuntimeError("CUDA error: an illegal memory access was "
                           "encountered"),
              torch.OutOfMemoryError("CUDA out of memory."),
              ValueError("fcnn_layer: a non-contiguous input")):
        with pytest.raises(type(e)) as raised:
            runner._fall_back(0, e)
        assert raised.value is e
    assert runner.report.kernel_fallbacks == 0
    assert runner.executor.kernel_mode is None


def test_kernel_calls_per_step_follow_each_ring(monkeypatch):
    """K1/K2/K3 calls: steps 0-3 on the 8-device program, steps 4-7 on the
    6-device one; the faulted step launches nothing."""
    calls = {"fwd": 0, "dgrad": 0, "wgrad": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(pruntime, "_KERNEL_FNS", tuple(
        counted(n, f) for n, f in zip(calls, pruntime._KERNEL_FNS)))
    _port("loss_8_to_6", N_DEV, residency="sharded")
    planner = ElasticPlanner(FCNNWorkload(SIZES, batch_size=BATCH),
                             ONoCConfig(m=8, lambda_max=64))
    want = {"fwd": 0, "dgrad": 0, "wgrad": 0}
    for n in (8, 6):
        degrees = planner.replan_program(n)[2].degrees
        want["fwd"] += 4 * sum(degrees)
        want["wgrad"] += 4 * sum(degrees)
        want["dgrad"] += 4 * sum(degrees[1:])
    assert calls == want


# ------------------------------------------------------------- the launcher


def test_elastic_restart_runs_the_example_on_cpu(capsys):
    assert elastic_restart.main(["--device", "cpu", "--sizes", "32", "16",
                                 "8", "10"]) == 0
    out = capsys.readouterr().out
    assert "completed 119 steps with 1 injected failure" in out
    assert "cluster size  100: allocation [64, 64, 10]" in out
    assert "device loss at step 185 period 4: lost [2, 3], replanned 8 -> " \
        "6 devices, resumed from checkpoint 149" in out
    assert "ring of 8 devices, degrees [8, 8, 2]: steps 0-185" in out
    assert "ring of 6 devices, degrees [2, 2, 2]: steps 150-299" in out
    assert "report: retries 2, kernel fallbacks 0" in out
    assert "against a from-scratch run on 6 devices" in out


def test_elastic_restart_fails_on_a_kernel_fallback(monkeypatch):
    report = faults.FaultReport(kernel_fallbacks=1)
    monkeypatch.setattr(elastic_restart, "crash_restart", lambda dev: [])
    monkeypatch.setattr(elastic_restart, "device_loss_replan_resume",
                        lambda sc, dev: {"faulted": {"report": report,
                                                     "accuracy": 1.0}})
    assert elastic_restart.main(["--device", "cpu"]) == 1


def test_elastic_restart_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic_restart.main(["--sizes", "32", "16", "8", "10"])


def test_nn1_scenario_schedule():
    """The card's scenario: NN1's 8 devices lose 2 at step 185, period 4
    (resumed from the checkpoint of step 149), survivors 2/2/2; a
    transient RUN fault at step 10 fails twice."""
    sc = elastic_restart.NN1_SCENARIO
    assert sc.sizes == (784, 1000, 500, 10) and elastic_restart.BATCH == 64
    sched = elastic_restart.fault_schedule(sc)
    assert [(e.kind.value, e.step, e.period, e.device, e.count)
            for e in sched.events] == [
        ("device_loss", 185, 4, 2, 1), ("device_loss", 185, 4, 3, 1),
        ("transient_run", 10, 1, 0, 2)]
    planner = ElasticPlanner(FCNNWorkload(list(sc.sizes), batch_size=64),
                             elastic_restart.ONOC)
    assert planner.replan_program(8)[2].degrees == (8, 4, 2)
    assert planner.replan_program(6)[2].degrees == (2, 2, 2)
