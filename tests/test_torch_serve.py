"""The port's serving slice (``repro_torch.serve``) against the JAX
reference (``repro.serve``) on the Zamba2 smoke config.

  * the copied traffic generator gives bit-identical traces and prompt
    tokens for every preset, and ``snap_prompt_buckets`` and the SLO
    report agree with the reference's;
  * end to end: the reference's ``JaxModelRunner`` and the port's
    ``TorchModelRunner`` (on the CPU, from the same numpy parameters),
    each under its own ``ServingEngine`` with a ``TickClock``, give
    identical token streams, counts and SLO reports;
  * admission touches only the admitted slot's cache rows, and an
    in-flight stream is unchanged by someone else's admission;
  * a scheduled device loss costs no tokens: the streams equal those of
    the same trace served without the fault.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.serve import metrics as j_metrics
from repro.serve import traffic as j_traffic
from repro.serve.runner import JaxModelRunner
from repro.serve.runner import snap_prompt_buckets as j_snap
from repro.serve.scheduler import ServingEngine as JServingEngine
from repro.serve.scheduler import TickClock as JTickClock
from repro_torch.configs import smoke_config
from repro_torch.serve import (
    SCENARIO_NAMES,
    ServeAutoscaler,
    ServeMetrics,
    ServingEngine,
    TickClock,
    TorchModelRunner,
    make_traffic,
    prompt_tokens,
    scenario_preset,
    snap_prompt_buckets,
)

ARCH = "zamba2-1.2b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return smoke_config(ARCH)


@pytest.mark.parametrize("name", SCENARIO_NAMES)
@pytest.mark.parametrize("seed", [0, 3])
def test_traffic_is_bit_identical_to_the_reference(name, seed):
    ours = make_traffic(scenario_preset(name), seed)
    theirs = j_traffic.make_traffic(j_traffic.scenario_preset(name), seed)
    assert ours.to_dicts() == theirs.to_dicts()
    assert (ours.seed, ours.scenario) == (theirs.seed, theirs.scenario)
    assert dataclasses.asdict(scenario_preset(name)) == dataclasses.asdict(
        j_traffic.scenario_preset(name))
    for ev, jev in zip(ours.events, theirs.events):
        for vocab in (256, 32000):
            np.testing.assert_array_equal(
                prompt_tokens(seed, ev, vocab),
                j_traffic.prompt_tokens(seed, jev, vocab))


def test_snap_buckets_and_slo_report_agree_with_the_reference(cfg):
    jcfg = j_smoke_config(ARCH)
    for buckets in ((9,), (5, 8, 13), (512, 1000, 2048), (8, 16, 32)):
        assert snap_prompt_buckets(cfg, buckets) == j_snap(jcfg, buckets)
    assert snap_prompt_buckets(smoke_config(ARCH).replace(family="dense"),
                               (16, 8, 8)) == (8, 16)
    rng = np.random.default_rng(0)
    ours, theirs = ServeMetrics(), j_metrics.ServeMetrics()
    for rid in range(7):
        t0 = float(rng.uniform(0, 1))
        events = [("on_submit", (rid, t0, 8, 4)),
                  ("on_admit", (rid, t0 + 0.1)),
                  ("on_first_token", (rid, t0 + float(rng.uniform(0.1, 1)))),
                  ("on_finish", (rid, t0 + 2.0, int(rng.integers(1, 9))))]
        if rid == 3:
            events.insert(2, ("on_restart", (rid,)))
        for m in (ours, theirs):
            for fn, args in events:
                getattr(m, fn)(*args)
    for slo in ((float("inf"), float("inf")), (0.5, 0.3)):
        assert ours.report(*slo).to_row() == theirs.report(*slo).to_row()
    assert ours.recent_p99_ttft(4) == theirs.recent_p99_ttft(4)


@pytest.fixture(scope="module")
def reference_runner():
    sc = scenario_preset("steady", n_requests=6)
    return JaxModelRunner(j_smoke_config(ARCH), n_slots=2, max_len=sc.max_len,
                          devices=jax.devices()[:1])


def _numpy_params(runner):
    return jax.tree.map(np.asarray, runner._host_params)


def test_served_streams_equal_the_reference_end_to_end(cfg, reference_runner):
    """The slice end to end: same trace, same numpy parameters, both
    engines on virtual time — identical token streams."""
    sc = scenario_preset("steady", n_requests=6)
    sc = sc.replace(prompt_buckets=snap_prompt_buckets(cfg, sc.prompt_buckets))
    trace = make_traffic(sc, seed=0)
    j_trace = j_traffic.make_traffic(
        j_traffic.scenario_preset("steady", n_requests=6).replace(
            prompt_buckets=sc.prompt_buckets), 0)
    theirs = JServingEngine(reference_runner, n_slots=2,
                            clock=JTickClock()).run(j_trace, sc)
    runner = TorchModelRunner(cfg, n_slots=2, max_len=sc.max_len,
                              device="cpu",
                              params=_numpy_params(reference_runner))
    ours = ServingEngine(runner, n_slots=2, clock=TickClock()).run(trace, sc)
    assert set(ours.streams) == set(trace.rids)
    assert ours.streams == theirs.streams
    assert (ours.n_prefills, ours.n_decode_steps) == (theirs.n_prefills,
                                                      theirs.n_decode_steps)
    assert ours.slo.to_row() == theirs.slo.to_row()
    for ev in trace.events:
        assert len(ours.streams[ev.rid]) == ev.gen_len


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=n).astype(
        np.int32)


def _decode(runner, streams, steps):
    for _ in range(steps):
        last = np.zeros(runner.n_slots, np.int32)
        for slot, toks in streams.items():
            last[slot] = toks[-1]
        nxt = runner.decode(last)
        for slot in streams:
            streams[slot].append(int(nxt[slot]))


def test_admission_touches_only_its_own_slot(cfg):
    runner = TorchModelRunner(cfg, n_slots=3, max_len=24, device="cpu")
    runner.prefill(0, _prompt(0, 8, cfg.vocab_size))
    before = {k: v.clone() for k, v in runner.cache.items()}
    runner.prefill(2, _prompt(2, 16, cfg.vocab_size))
    touched = 0
    for key, axes in runner.model.cache_axes().items():
        i = axes.index("cache_batch")
        for slot in (0, 1):
            torch.testing.assert_close(runner.cache[key].select(i, slot),
                                       before[key].select(i, slot),
                                       rtol=0, atol=0)
        touched += not torch.equal(runner.cache[key].select(i, 2),
                                   before[key].select(i, 2))
    assert touched == len(before)
    assert runner.cache["len"].tolist() == [8, 0, 16]


def test_mid_stream_admission_leaves_inflight_stream_unchanged(cfg):
    pa, pb = _prompt(0, 8, cfg.vocab_size), _prompt(1, 16, cfg.vocab_size)
    solo = TorchModelRunner(cfg, n_slots=2, max_len=24, device="cpu")
    ref = {0: [solo.prefill(0, pa)]}
    _decode(solo, ref, 6)
    shared = TorchModelRunner(cfg, n_slots=2, max_len=24, device="cpu")
    streams = {0: [shared.prefill(0, pa)]}
    _decode(shared, streams, 3)
    streams[1] = [shared.prefill(1, pb)]        # the mid-stream admission
    _decode(shared, streams, 3)
    assert streams[0] == ref[0]


def test_runner_guards(cfg):
    runner = TorchModelRunner(cfg, n_slots=2, max_len=24, device="cpu")
    with pytest.raises(IndexError, match="slot"):
        runner.prefill(5, _prompt(0, 8, cfg.vocab_size))
    with pytest.raises(ValueError, match="max_len"):
        runner.prefill(0, _prompt(0, 24, cfg.vocab_size))
    with pytest.raises(ValueError, match="at least one device"):
        runner.rebuild(n_devices=0)
    with pytest.raises(ValueError, match="token-LM"):
        TorchModelRunner(cfg.replace(family="vlm"), 2, 24, device="cpu")
    runner.rebuild(n_devices=1, n_slots=3)
    assert runner.n_slots == 3 and runner.cache["len"].shape == (3,)
    assert runner.n_devices == 1


def test_device_loss_mid_decode_streams_match_no_fault_run(cfg):
    """One trace served under the ``device-loss-mid-decode`` preset (the
    loss fires at decode step 2) and under ``steady``, through the Lemma-1
    autoscaler of a one-device ring, as the serve CLI runs it: the same
    streams."""
    overrides = dict(n_requests=6, prompt_buckets=(8,), gen_buckets=(4, 8))
    lossy = scenario_preset("device-loss-mid-decode", device_loss=(2, 2),
                            **overrides)
    steady = scenario_preset("steady", **overrides)
    trace = make_traffic(steady, seed=0)
    params = TorchModelRunner(cfg, 1, 2, device="cpu").params
    numpy_params = jax.tree.map(lambda t: t.numpy(), params)

    def serve(run_sc):
        runner = TorchModelRunner(cfg, n_slots=3, max_len=steady.max_len,
                                  device="cpu", params=numpy_params)
        return ServingEngine(runner, n_slots=3, clock=TickClock(0.01),
                             autoscaler=ServeAutoscaler(1, 3)).run(trace,
                                                                   run_sc)

    faulted, clean = serve(lossy), serve(steady)
    assert [r.reason for r in faulted.replans] == ["device_loss"]
    # a one-device ring losing 2 keeps one device: the same epoch price,
    # so the same slots
    rp = faulted.replans[0]
    assert (rp.from_devices, rp.to_devices, rp.from_slots,
            rp.to_slots) == (1, 1, 3, 3)
    assert rp.epoch_s == ServeAutoscaler(1, 3)._base_epoch_s
    assert len(rp.lemma1_cores) > 0
    assert faulted.slo.n_restarts >= 1
    assert not clean.replans and clean.slo.n_restarts == 0
    assert faulted.streams == clean.streams
    assert set(faulted.streams) == set(trace.rids)
    for ev in trace.events:
        assert len(faulted.streams[ev.rid]) == ev.gen_len
