"""The port's fault layer against the reference's: ``runtime/faults.py``
(schedules, the injector, fault-aware epoch pricing), the planning half
of ``runtime/elastic.py`` and ``runtime/fault_tolerance.py``
(``StragglerMonitor``, ``TrainingSupervisor``).

These modules are framework-free copies, so they are held equal to the
reference exactly: the same schedules, the same faults fired at the same
instruction boundaries with the same report, the same prices to the last
bit, the same plans and program JSON, the same straggler flags and the
same supervisor history and checkpoints.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs.nn_benchmarks import onoc_config, workload
from repro.core.onoc_model import FCNNWorkload as JWorkload
from repro.core.simulator import ENoCBackend as JENoC
from repro.core.simulator import ONoCBackend as JONoC
from repro.core.simulator import simulate_epoch as j_simulate
from repro.exec.program import compile_fcnn_program as j_compile
from repro.runtime import elastic as jelastic
from repro.runtime import fault_tolerance as jft
from repro.runtime import faults as jf
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.core.simulator import ENoCBackend, ONoCBackend, simulate_epoch
from repro_torch.exec.program import compile_fcnn_program
from repro_torch.runtime import elastic, fault_tolerance, faults

NN = ["NN1", "NN2", "NN3", "NN4", "NN5", "NN6"]
STRATEGIES = ["fm", "rrm", "orrm"]
ALL_RATES = {k: 0.2 for k in faults.FaultKind}


def _cfg(m=1000):
    return ONoCConfig(m=m, lambda_max=64)


def _wl(nn, batch=64):
    return FCNNWorkload(workload(nn).layer_sizes, batch_size=batch)


def _jwl(nn, batch=64):
    return workload(nn, batch_size=batch)


def _schedules(mod, seed):
    """A sampled schedule of every kind and a seeded device-loss burst,
    built by ``mod`` (the port's or the reference's faults module)."""
    rates = {mod.FaultKind(k.value): r for k, r in ALL_RATES.items()}
    return (mod.FaultSchedule.sample(seed, n_steps=40, n_devices=8,
                                     n_periods=6, rates=rates),
            mod.FaultSchedule.seeded_device_loss(
                seed, n_steps=60, n_devices=8, n_periods=6,
                n_lost=1 + seed % 3))


def _same_events(port, ref):
    """The reference's schedule in the port's classes."""
    return faults.FaultSchedule(
        events=tuple(faults.FaultEvent(**{**e, "kind": faults.FaultKind(
            e["kind"])}) for e in ref.to_dicts()), seed=ref.seed)


# ----------------------------------------------------------------- schedules


@pytest.mark.parametrize("seed", [0, 1, 2, 7, 123])
def test_schedules_equal_the_reference(seed):
    for port, ref in zip(_schedules(faults, seed), _schedules(jf, seed)):
        assert port.to_dicts() == ref.to_dicts()
        assert port.seed == ref.seed
        for step in range(60):
            assert [e.to_dict() for e in port.at(step)] == \
                [e.to_dict() for e in ref.at(step)]
            assert len(port.device_losses(step)) == \
                len(ref.device_losses(step))
            assert len(port.transient_runs(step)) == \
                len(ref.transient_runs(step))


# ------------------------------------------------------------------ injector


def _walk(mod, program, schedule, n_steps):
    """Every step's instruction walk through ``mod``'s injector, retrying
    a step after a transient fault and moving on after a device loss: the
    (step, period, fault, devices) sequence and the report."""
    inj = mod.FaultInjector(schedule, timeout_s=0.5)
    seq = []
    for step in range(n_steps):
        for _ in range(10):
            try:
                for instr in program.instructions:
                    inj.instruction_boundary(step, instr)
            except mod.TransientRunFault as e:
                seq.append((step, e.period, "transient", e.device))
                continue
            except mod.DeviceLossFault as e:
                seq.append((step, e.period, "loss", e.devices))
            break
        inj.observe_step(step, 1.0 if step % 5 == 0 else 0.1)
    return seq, inj.report.to_dict()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("nn,strategy", [("NN1", "orrm"), ("NN2", "fm")])
def test_injector_fires_as_the_reference(seed, nn, strategy):
    port_prog = compile_fcnn_program(_wl(nn), _cfg(), 8, strategy)
    ref_prog = j_compile(_jwl(nn), onoc_config(64), 8, strategy)
    sampled, burst = _schedules(jf, seed)
    counted = jf.FaultSchedule(events=sampled.events + (
        jf.FaultEvent(kind=jf.FaultKind.TRANSIENT_RUN, step=3, period=0,
                      device=1, count=3),))
    for ref_sched in (counted, burst):
        port = _walk(faults, port_prog, _same_events(faults, ref_sched), 60)
        ref = _walk(jf, ref_prog, ref_sched, 60)
        assert port == ref
        assert port[0], "the schedule fired nothing"


# ------------------------------------------------------------------- pricing


def _pricing_schedule(mod):
    K = mod.FaultKind
    return mod.FaultSchedule(events=(
        mod.FaultEvent(kind=K.WAVELENGTH_DEGRADE, step=0, magnitude=0.4),
        mod.FaultEvent(kind=K.LINK_DEGRADE, step=0, period=2, magnitude=0.3),
        mod.FaultEvent(kind=K.STRAGGLER, step=0, period=3, magnitude=2.5),
        mod.FaultEvent(kind=K.TRANSIENT_RUN, step=0, period=1, count=2),
        mod.FaultEvent(kind=K.TRANSIENT_RUN, step=0, period=5),
        mod.FaultEvent(kind=K.DEVICE_LOSS, step=0, period=4, device=3),
        mod.FaultEvent(kind=K.DEVICE_LOSS, step=0, period=4, device=9),
    ))


def _no_loss(mod):
    s = _pricing_schedule(mod)
    return mod.FaultSchedule(events=tuple(
        e for e in s.events if e.kind is not mod.FaultKind.DEVICE_LOSS))


@pytest.mark.parametrize("nn", NN)
@pytest.mark.parametrize("enoc", [False, True], ids=["onoc", "enoc"])
def test_pricing_equals_the_reference(nn, enoc):
    for strategy in STRATEGIES:
        for sched in (_pricing_schedule, _no_loss):
            port = faults.expected_epoch_time(
                _wl(nn), _cfg(), sched(faults), step=0, strategy=strategy,
                backend=ENoCBackend() if enoc else ONoCBackend())
            ref = jf.expected_epoch_time(
                _jwl(nn), onoc_config(64), sched(jf), step=0,
                strategy=strategy, backend=JENoC() if enoc else JONoC())
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
            assert port.overhead_pct == ref.overhead_pct
        ef = faults.EpochFaults.from_schedule(_pricing_schedule(faults), 0)
        jef = jf.EpochFaults.from_schedule(_pricing_schedule(jf), 0)
        assert dataclasses.asdict(ef) == dataclasses.asdict(jef)
        tr = simulate_epoch(_wl(nn), _cfg(), strategy=strategy, faults=ef,
                            backend=ENoCBackend() if enoc else None)
        jtr = j_simulate(_jwl(nn), onoc_config(64), strategy=strategy,
                         faults=jef, backend=JENoC() if enoc else None)
        assert tr.per_period_compute_s == jtr.per_period_compute_s
        assert [t.comm_s for t in tr.transitions] == \
            [t.comm_s for t in jtr.transitions]


def test_pricing_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="not a MappingStrategy"):
        faults.FaultPricing(backend="onoc", strategy="nope", nominal_s=1.0,
                            degraded_s=1.0, loss_period=None, survivors=1,
                            prefix_s=0.0, re_transition_s=0.0,
                            replanned_epoch_s=0.0, expected_s=1.0)
    total = faults.FaultSchedule(events=tuple(
        faults.FaultEvent(kind=faults.FaultKind.DEVICE_LOSS, step=0,
                          period=1, device=d) for d in range(4)))
    with pytest.raises(ValueError, match="no surviving cores"):
        faults.expected_epoch_time(_wl("NN1"), _cfg(4), total, step=0)


# ------------------------------------------------------------------ planning


@pytest.mark.parametrize("sizes", [[784, 1000, 500, 10], [32, 16, 8, 10]])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_replanning_equals_the_reference(sizes, strategy):
    port = elastic.ElasticPlanner(FCNNWorkload(sizes, batch_size=64),
                                  _cfg(8), strategy=strategy)
    ref = jelastic.ElasticPlanner(JWorkload(sizes, batch_size=64),
                                  dataclasses.replace(onoc_config(64), m=8),
                                  strategy=strategy)
    for n in (1000, 500, 100):
        (pc, pcores, pmap), (rc, rcores, rmap) = port.plan_for(n), \
            ref.plan_for(n)
        assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
        assert pcores == rcores
        assert pmap.windows == rmap.windows
        assert pmap.active_cores() == rmap.active_cores()
    for n in range(8, 0, -1):
        pc, pplan, pprog = port.replan_program(n)
        rc, rplan, rprog = ref.replan_program(n)
        assert pc.m == rc.m == n
        assert pplan.degrees == rplan.degrees
        assert pprog.to_json() == rprog.to_json()


# ------------------------------------------------------- fault_tolerance


@pytest.mark.parametrize("window,factor", [(8, 2.0), (32, 3.0), (16, 1.5)])
def test_straggler_flags_equal_the_reference(window, factor):
    rng = np.random.default_rng(window)
    durations = rng.lognormal(0.0, 0.8, size=200)
    seen = {"port": [], "ref": []}
    port = fault_tolerance.StragglerMonitor(
        deadline_factor=factor, window=window,
        on_straggler=lambda *a: seen["port"].append(a))
    ref = jft.StragglerMonitor(
        deadline_factor=factor, window=window,
        on_straggler=lambda *a: seen["ref"].append(a))
    flags = [(port.observe(i, d), ref.observe(i, d))
             for i, d in enumerate(durations)]
    assert all(a == b for a, b in flags) and any(a for a, _ in flags)
    assert port.straggler_steps == ref.straggler_steps
    assert seen["port"] == seen["ref"]
    assert port._times.maxlen == window


class _Count:
    """An iterator of batches {"x": i} with the Batcher's state/restore."""

    def __init__(self):
        self.step = 0

    def __iter__(self):
        return self

    def __next__(self):
        self.step += 1
        return {"x": self.step - 1}

    def state(self):
        return {"step": self.step}

    def restore(self, state):
        self.step = int(state["step"])


def _supervise(ck, state, fail_calls, max_retries, fatal=()):
    """Run 12 steps of w += x under a supervisor whose step fails at the
    given call numbers; the history without its host times."""
    sup_mod = fault_tolerance if isinstance(ck, Checkpointer) else jft
    sup = sup_mod.TrainingSupervisor(ck, checkpoint_every=3,
                                     max_retries=max_retries, backoff_s=0.0,
                                     fatal=fatal)
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] in fail_calls:
            ck.wait()   # the restart must see the last async save
            raise RuntimeError(f"failure at call {calls['n']}")
        return {"w": state["w"] + batch["x"]}, {"x": batch["x"]}

    state, hist = sup.run(state, step_fn, _Count(), 12)
    return state, [(h["step"], h["x"]) for h in hist], calls["n"]


@pytest.mark.parametrize("fail_calls,max_retries", [
    ((), 3), ((2, 3), 3), ((5,), 0), ((8, 9, 10), 1)])
def test_supervisor_equals_the_reference(tmp_path, fail_calls, max_retries):
    port = _supervise(Checkpointer(str(tmp_path / "port")),
                      {"w": torch.zeros(3)}, fail_calls, max_retries)
    ref = _supervise(JCheckpointer(str(tmp_path / "ref")),
                     {"w": jnp.zeros(3)}, fail_calls, max_retries)
    assert port[1:] == ref[1:]
    np.testing.assert_array_equal(port[0]["w"].numpy(), np.asarray(ref[0]["w"]))
    for d in ("port", "ref"):
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == \
            ["step_11", "step_5", "step_8"]


def test_supervisor_lets_fatal_faults_through(tmp_path):
    sup = fault_tolerance.TrainingSupervisor(
        Checkpointer(str(tmp_path)), checkpoint_every=0, max_retries=5,
        backoff_s=0.0, fatal=(faults.DeviceLossFault,))
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        raise faults.DeviceLossFault(0, 1, (3,))

    with pytest.raises(faults.DeviceLossFault):
        sup.run({"w": torch.zeros(())}, step_fn, _Count(), 4)
    assert calls["n"] == 1                  # no retry of a fatal fault


def test_supervisor_resumes_from_an_existing_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state, hist, _ = _supervise(ck, {"w": torch.zeros(3)}, (), 3)
    assert math.isclose(float(state["w"][0]), sum(range(12)))
    # a second run over the same directory resumes after step 11: nothing
    # is left to do, and the state is the checkpoint's
    state2, hist2, calls = _supervise(ck, {"w": torch.zeros(3)}, (), 3)
    assert hist2 == [] and calls == 0
    assert torch.equal(state2["w"], state["w"])
