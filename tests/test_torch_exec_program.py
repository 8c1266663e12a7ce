"""The port's copies of the period-program modules (compiler, simulator,
validator, analyzer, corruption corpus, residency tracker) and of the
global-norm clip, held equal to the reference's on the same inputs.

Programs are compared as ``to_json`` strings.  Cost totals are compared
transition by transition, never as sums: the program adds with builtin
``sum()`` and the simulator with ``+=``, which may differ in the last bit
(in the reference as in the port).
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro.configs.nn_benchmarks import NN_BENCHMARKS
from repro.core import simulator as j_sim
from repro.core.onoc_model import FCNNWorkload as JWorkload
from repro.core.onoc_model import ONoCConfig as JONoC
from repro.core.planner import plan_fcnn as j_plan_fcnn
from repro.core.planner import ring_mesh_axes as j_ring
from repro.exec import analysis as j_analysis
from repro.exec import program as j_program
from repro.exec import residency as j_residency
from repro.exec import validate as j_validate
from repro.optim.optimizers import clip_by_global_norm as j_clip
from repro_torch.core import simulator
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.core.planner import plan_fcnn, ring_mesh_axes
from repro_torch.exec import analysis, program, residency, validate
from repro_torch.launch.train_fcnn import cost_contract
from repro_torch.optim import clip_by_global_norm, global_norm

ARCHS = sorted(NN_BENCHMARKS)
STRATEGIES = ["fm", "rrm", "orrm"]
BACKENDS = ["onoc", "enoc"]
CFG, J_CFG = ONoCConfig(lambda_max=64), JONoC(lambda_max=64)


def _backends(name):
    if name == "onoc":
        return simulator.ONoCBackend(), j_sim.ONoCBackend()
    return simulator.ENoCBackend(), j_sim.ENoCBackend()


@functools.lru_cache(maxsize=None)
def _compiled(arch, strategy, backend, n, batch):
    """(port plan, port program, reference plan, reference program)."""
    sizes = NN_BENCHMARKS[arch]
    ours_b, ref_b = _backends(backend)
    w, jw = (FCNNWorkload(sizes, batch_size=batch),
             JWorkload(sizes, batch_size=batch))
    plan = plan_fcnn(w, CFG, ring_mesh_axes(n), strategy=strategy)
    j_plan = j_plan_fcnn(jw, J_CFG, j_ring(n), strategy=strategy)
    return (plan, program.compile_program(plan, w, CFG, n, backend=ours_b),
            j_plan,
            j_program.compile_program(j_plan, jw, J_CFG, n, backend=ref_b))


@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("n", [8, 12])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_program_json_equals_reference(arch, strategy, backend, n, batch):
    plan, ours, _, ref = _compiled(arch, strategy, backend, n, batch)
    text = ours.to_json()
    assert text == ref.to_json()
    again = program.PeriodProgram.from_json(text)
    assert again == ours and again.to_json() == text
    # the cost contract, RUN by RUN and transition by transition
    cost_contract(ours, FCNNWorkload(NN_BENCHMARKS[arch], batch_size=batch),
                  CFG, plan.mapping, backend=_backends(backend)[0])
    assert ours.compute_s == ref.compute_s and ours.comm_s == ref.comm_s


def test_v1_programs_load_as_in_the_reference():
    _, ours, _, ref = _compiled("NN1", "orrm", "onoc", 8, 64)
    d = json.loads(ours.to_json())
    d["version"] = 1
    for ins in d["instructions"]:
        ins.pop("param_bytes")
    text = json.dumps(d)
    ours_v1 = program.PeriodProgram.from_json(text)
    assert ours_v1.to_json() == j_program.PeriodProgram.from_json(
        text).to_json()
    assert ours_v1.version == 1
    d["version"] = 3
    for load in (program.PeriodProgram.from_json,
                 j_program.PeriodProgram.from_json):
        with pytest.raises(ValueError, match="unsupported program version"):
            load(json.dumps(d))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_simulate_epoch_trace_equals_reference(arch, strategy, backend):
    sizes = NN_BENCHMARKS[arch]
    ours_b, ref_b = _backends(backend)
    for lam in (8, 64):
        ours = simulator.simulate_epoch(
            FCNNWorkload(sizes, batch_size=64), ONoCConfig(lambda_max=lam),
            strategy=strategy, backend=ours_b)
        ref = j_sim.simulate_epoch(
            JWorkload(sizes, batch_size=64), JONoC(lambda_max=lam),
            strategy=strategy, backend=ref_b)
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(ref, f.name)
            if f.name == "core_busy_s":
                np.testing.assert_array_equal(a, b)
            elif f.name == "transitions":
                assert [dataclasses.astuple(t) for t in a] == [
                    dataclasses.astuple(t) for t in b]
            else:
                assert a == b, f.name
        assert ours.total_bytes == ref.total_bytes
        assert ours.total_hop_bytes == ref.total_hop_bytes


@pytest.mark.parametrize("mode", ["sharded", "replicated"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_residency_tracker_equals_reference(arch, strategy, mode):
    _, ours_p, _, ref_p = _compiled(arch, strategy, "onoc", 8, 64)
    ours = residency.ResidencyTracker(ours_p, mode=mode)
    ref = j_residency.ResidencyTracker(ref_p, mode=mode)
    assert ([dataclasses.astuple(s) for s in ours.timeline()]
            == [dataclasses.astuple(s) for s in ref.timeline()])
    assert ours.peak_ratio() == ref.peak_ratio()
    assert ours.release_periods() == ref.release_periods()
    assert ours.peak_bytes() == ref.peak_bytes()
    assert ours.final_bytes() == ref.final_bytes()
    assert (residency.replicated_model_bytes(ours_p)
            == j_residency.replicated_model_bytes(ref_p))


@pytest.mark.parametrize("level", ["fast", "full"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_analysis_report_equals_reference(arch, strategy, backend, level):
    _, ours_p, _, ref_p = _compiled(arch, strategy, backend, 8, 64)
    sizes = NN_BENCHMARKS[arch]
    ours_b, ref_b = _backends(backend)
    ours = analysis.analyze_program(
        ours_p, FCNNWorkload(sizes, batch_size=64), CFG, backend=ours_b,
        level=level)
    ref = j_analysis.analyze_program(
        ref_p, JWorkload(sizes, batch_size=64), J_CFG, backend=ref_b,
        level=level)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert analysis.analyze_program(ours_p, level="off") is None
    streams = analysis.expand_program(ours_p)
    j_streams = j_analysis.expand_program(ref_p)
    assert {d: [dataclasses.astuple(o) for o in ops]
            for d, ops in streams.items()} == {
        d: [dataclasses.astuple(o) for o in ops]
        for d, ops in j_streams.items()}


def _raised(fn):
    try:
        fn()
    except ValueError as e:   # ProgramValidationError and its subclass
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch", ["NN1", "NN2"])
def test_corruption_corpus_equals_reference(arch, seed):
    _, ours_p, _, ref_p = _compiled(arch, "orrm", "onoc", 8, 64)
    w = FCNNWorkload(NN_BENCHMARKS[arch], batch_size=64)
    jw = JWorkload(NN_BENCHMARKS[arch], batch_size=64)
    ours = analysis.corruption_corpus(ours_p, seed=seed)
    ref = j_analysis.corruption_corpus(ref_p, seed=seed)
    assert [e.name for e in ours] == [e.name for e in ref]
    for a, b in zip(ours, ref):
        assert (a.description, a.match) == (b.description, b.match)
        assert a.program.to_json() == b.program.to_json()
        got = _raised(lambda: analysis.analyze_program(a.program, w, CFG))
        want = _raised(lambda: j_analysis.analyze_program(b.program, jw,
                                                          J_CFG))
        assert got is not None and got[0] == "ProgramAnalysisError"
        assert got == want


def _corrupt(d, how):
    ins = d["instructions"]
    if how == "drop-run":
        ins[:] = [i for i in ins if not (i["opcode"] == "run"
                                         and i["period"] == 2)]
    elif how == "drop-send":
        ins[:] = [i for i in ins if not (i["opcode"] == "send"
                                         and i["period"] == 1)]
    elif how == "off-mesh":
        next(i for i in ins if i["opcode"] == "recv")["devices"][0] = 99
    elif how == "param-bytes":
        next(i for i in ins if i["opcode"] == "free"
             and i["layer"] is not None)["param_bytes"] += 4.0
    elif how == "cost":
        next(i for i in ins if i["opcode"] == "send"
             and i["period"] == 2)["cost_s"] *= 1.5
    elif how == "degree":
        d["degrees"][0] = 3
        ins[0]["degree"] = 3
    return json.dumps(d)


@pytest.mark.parametrize("how", ["drop-run", "drop-send", "off-mesh",
                                 "param-bytes", "cost", "degree"])
def test_validator_rejects_as_the_reference(how):
    _, ours_p, _, _ = _compiled("NN1", "orrm", "onoc", 8, 64)
    text = _corrupt(json.loads(ours_p.to_json()), how)
    w = FCNNWorkload(NN_BENCHMARKS["NN1"], batch_size=64)
    jw = JWorkload(NN_BENCHMARKS["NN1"], batch_size=64)
    got = _raised(lambda: validate.validate_program(
        program.PeriodProgram.from_json(text), w, CFG))
    want = _raised(lambda: j_validate.validate_program(
        j_program.PeriodProgram.from_json(text), jw, J_CFG))
    assert got is not None and got[0] == "ProgramValidationError"
    assert got == want


@pytest.mark.parametrize("max_norm", [0.05, 1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(0)
    tree = {"layers": [{"w": rng.normal(size=(40, 30)).astype(np.float32),
                        "b": rng.normal(size=(30,)).astype(np.float32)},
                       {"w": rng.normal(size=(30, 10)).astype(np.float32),
                        "b": rng.normal(size=(10,)).astype(np.float32)}]}
    ours, norm = clip_by_global_norm(
        {"layers": [{k: torch.from_numpy(v) for k, v in lp.items()}
                    for lp in tree["layers"]]}, max_norm)
    ref, j_norm = j_clip(tree, max_norm)
    np.testing.assert_allclose(norm.item(), float(j_norm), rtol=1e-6)
    for lo, lr in zip(ours["layers"], ref["layers"]):
        for k in ("w", "b"):
            assert lo[k].dtype == torch.float32
            np.testing.assert_allclose(lo[k].numpy(), np.asarray(lr[k]),
                                       rtol=1e-6, atol=1e-7)
    assert global_norm(ours).item() <= max(max_norm, norm.item()) * (1 + 1e-6)
