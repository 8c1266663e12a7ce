"""The port's Lemma-1 serving autoscaler (``repro_torch.serve.elastic``)
and its runner's logical device ring, against the JAX reference.

  * ``ServeAutoscaler`` against the reference's on the same inputs: a loss
    of 8 -> 6 devices, SLO growth to saturation, and the slot floor at
    8 -> 1; every ``ReplanDecision`` equal field for field (``epoch_s``
    included: both programs' ``comm_s`` sum in the same order, ROADMAP.md
    R1);
  * the runner: a ring of 8 logical devices rebuilt to 6 devices and 2 -> 3
    slots gives the same first token, and a ring of 0 is refused;
  * the reference's device-loss scenario (``tests/test_serve_elastic.py``)
    on the fp32 Zamba2 and qwen3-14b smoke configs, the port's runner on
    the reference runner's parameters: the port's streams equal its own
    no-fault run's and the reference's, and its decisions the reference's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.serve.elastic import ServeAutoscaler as JServeAutoscaler
from repro.serve.runner import JaxModelRunner
from repro.serve.scheduler import ServingEngine as JServingEngine
from repro.serve.scheduler import TickClock as JTickClock
from repro_torch.configs import smoke_config
from repro_torch.serve import (
    ReplanDecision,
    ServeAutoscaler,
    ServingEngine,
    TickClock,
    TorchModelRunner,
    make_traffic,
    scenario_preset,
    snap_prompt_buckets,
)
from repro_torch.serve import scheduler

N_DEV = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(ours, theirs):
    assert isinstance(ours, ReplanDecision)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.to_dict() == theirs.to_dict()


def test_scheduler_takes_replan_decision_from_elastic():
    assert scheduler.ReplanDecision is ReplanDecision
    assert "ReplanDecision" not in scheduler.__all__


@pytest.mark.parametrize("n_dev,slots,lost", [(8, 4, 2), (8, 4, 1),
                                              (16, 6, 5), (6, 3, 2)])
def test_device_loss_decision_matches_reference(n_dev, slots, lost):
    ours, theirs = ServeAutoscaler(n_dev, slots), JServeAutoscaler(n_dev, slots)
    assert ours._base_epoch_s == theirs._base_epoch_s
    d = ours.on_device_loss(lost, now=1.5)
    _same(d, theirs.on_device_loss(lost, now=1.5))
    assert (d.from_devices, d.to_devices) == (n_dev, n_dev - lost)
    assert d.to_slots <= d.from_slots and d.epoch_s > ours._base_epoch_s
    assert all(1 <= c <= n_dev - lost for c in d.lemma1_cores)
    assert ours.events == [d]
    # a second loss prices the ring from where the first left it
    _same(ours.on_device_loss(1, now=2.0), theirs.on_device_loss(1, now=2.0))


def test_slo_growth_to_saturation_matches_reference():
    ours, theirs = ServeAutoscaler(N_DEV, 4), JServeAutoscaler(N_DEV, 4)
    _same(ours.on_device_loss(2, now=1.0), theirs.on_device_loss(2, now=1.0))
    t = 2.0
    while True:
        d, want = (ours.on_slo_violation(t, 1.0),
                   theirs.on_slo_violation(t, 1.0))
        if want is None:
            assert d is None
            break
        _same(d, want)
        assert d.reason == "slo_violation" and d.to_devices == 6
        t += 1.0
    assert ours.n_slots == ours.max_slots == theirs.n_slots == 8
    assert len(ours.events) == len(theirs.events) >= 3


def test_slot_floor_at_one_device_matches_reference():
    ours = ServeAutoscaler(N_DEV, n_slots=2, min_slots=1)
    theirs = JServeAutoscaler(N_DEV, n_slots=2, min_slots=1)
    d = ours.on_device_loss(N_DEV - 1, now=0.0)
    _same(d, theirs.on_device_loss(N_DEV - 1, now=0.0))
    assert d.to_devices == 1 and d.to_slots >= 1
    assert d.to_dict()["lemma1_cores"] == list(d.lemma1_cores)
    # losing more than the ring holds leaves one device
    _same(ours.on_device_loss(3, now=1.0), theirs.on_device_loss(3, now=1.0))
    assert ours.n_devices == 1


def test_runner_rebuilds_its_logical_ring():
    cfg = smoke_config("zamba2-1.2b")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=16).astype(np.int32)
    runner = TorchModelRunner(cfg, n_slots=2, max_len=24, device="cpu",
                              n_devices=N_DEV)
    assert runner.n_devices == N_DEV
    params = runner.params
    first = runner.prefill(1, prompt)
    runner.rebuild(n_devices=6, n_slots=3)
    assert (runner.n_devices, runner.n_slots) == (6, 3)
    assert runner.params is params                 # stays on the card
    assert runner.cache["len"].tolist() == [0, 0, 0]
    assert runner.prefill(2, prompt) == first
    runner.rebuild(n_slots=1)                      # the ring as it was
    assert (runner.n_devices, runner.n_slots) == (6, 1)
    with pytest.raises(ValueError, match="at least one device"):
        runner.rebuild(n_devices=0)
    assert runner.n_devices == 6
    with pytest.raises(ValueError, match="at least one device"):
        TorchModelRunner(cfg, 2, 24, device="cpu", n_devices=0)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen3-14b"])
def test_device_loss_scenario_matches_reference(arch):
    """tests/test_serve_elastic.py's scenario: 6 requests, 8-token prompts,
    a loss of 2 of 8 devices at decode step 2, 3 slots."""
    over = dict(dtype="float32", param_dtype="float32")
    cfg = smoke_config(arch).replace(**over)
    jcfg = j_smoke_config(arch).replace(**over)
    sc = scenario_preset("device-loss-mid-decode", n_requests=6,
                         prompt_buckets=(8,), gen_buckets=(4, 8),
                         device_loss=(2, 2))
    assert snap_prompt_buckets(cfg, sc.prompt_buckets) == (8,)
    trace = make_traffic(sc, seed=0)

    jrunner = JaxModelRunner(jcfg, n_slots=3, max_len=sc.max_len)
    assert jrunner.n_devices == N_DEV
    jres = JServingEngine(
        jrunner, n_slots=3, clock=JTickClock(0.01),
        autoscaler=JServeAutoscaler(jrunner.n_devices, 3)).run(trace, sc)
    params = jax.tree.map(np.asarray, jrunner._host_params)

    def serve(run_sc):
        runner = TorchModelRunner(cfg, n_slots=3, max_len=sc.max_len,
                                  device="cpu", params=params,
                                  n_devices=N_DEV)
        engine = ServingEngine(runner, n_slots=3, clock=TickClock(0.01),
                               autoscaler=ServeAutoscaler(runner.n_devices,
                                                          3))
        return engine.run(trace, run_sc), runner

    faulted, runner = serve(sc)
    clean, _ = serve(sc.replace(device_loss=None))
    assert [r.reason for r in faulted.replans] == ["device_loss"]
    assert len(faulted.replans) == len(jres.replans) == 1
    _same(faulted.replans[0], jres.replans[0])
    assert (faulted.replans[0].from_devices,
            faulted.replans[0].to_devices) == (N_DEV, 6)
    assert (runner.n_devices, runner.n_slots) == (
        jrunner.n_devices, jrunner.n_slots)
    assert faulted.slo.n_restarts == jres.slo.n_restarts >= 1
    assert not clean.replans and clean.slo.n_restarts == 0
    assert faulted.streams == clean.streams == jres.streams
    assert set(faulted.streams) == set(trace.rids)
    for ev in trace.events:
        assert len(faulted.streams[ev.rid]) == ev.gen_len
    assert (faulted.n_prefills, faulted.n_decode_steps) == (
        jres.n_prefills, jres.n_decode_steps)
