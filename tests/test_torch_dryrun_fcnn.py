"""The port's FCNN dry-run (``launch/dryrun_fcnn.py``): the reference's
per-layer plan (``repro.core.planner.plan_fcnn``, importable here: it sets
no XLA flags) equal on the production mesh's shape and the multipod one
for NN1-NN6 at batch 128; the step on meta against a real CPU step of the
same sharded ORRM program on 8 logical devices: predicted K1-K5 launches
equal the wrapper calls the CPU step makes (a spy around the executor's
kernel table and the loss wrappers) and the program's own count; with
``kernel_mode="ref"`` the counted aten flops equal ``FlopCounterMode``'s
count of the CPU step; the per-device chunk flops and the loss kernels'
add up to the step's kernel flops; the SEND bytes of NN1.
"""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.nn_benchmarks import onoc_config as j_onoc_config
from repro.configs.nn_benchmarks import workload as j_workload
from repro.core.planner import plan_fcnn as j_plan_fcnn
from repro_torch import exec as pexec
from repro_torch.configs.nn_benchmarks import (
    NN_BENCHMARKS,
    onoc_config,
    workload,
)
from repro_torch.exec import runtime
from repro_torch.kernels import cost, ops
from repro_torch.launch import dryrun_fcnn as D
from repro_torch.optim import adam

NNS = sorted(NN_BENCHMARKS)


@pytest.mark.parametrize("mesh", [D.PRODUCTION_MESH, D.MULTIPOD_MESH],
                         ids=["16x16", "2x16x16"])
def test_plan_degrees_and_cores_equal_reference(mesh):
    for name in NNS:
        want = j_plan_fcnn(j_workload(name, 128), j_onoc_config(64),
                           dict(mesh), strategy="orrm")
        got = D.plan_fcnn(workload(name, 128), onoc_config(64), dict(mesh),
                          strategy="orrm")
        assert got.degrees == want.degrees, name
        assert [p.onoc_cores for p in got.periods] == \
            [p.onoc_cores for p in want.periods], name


def test_run_nn_reports_the_reference_plan():
    nn3 = D.run_nn("NN3", 128)
    assert nn3["degrees"] == [16, 1, 16, 1, 1, 1]
    assert nn3["onoc_cores"] == [1000, 750, 784, 1000, 500, 10]
    assert D.run_nn("NN3", 128, multi_pod=True)["degrees"] == \
        j_plan_fcnn(j_workload("NN3", 128), j_onoc_config(64),
                    dict(D.MULTIPOD_MESH), strategy="orrm").degrees


def _cpu_step(name: str, batch: int, mode):
    exe = pexec.compile(workload(name, batch), onoc_config(64), 8,
                        strategy="orrm", residency="sharded",
                        kernel_mode=mode, device="cpu")
    opt = adam(1e-3)
    state = exe.init_state(torch.Generator().manual_seed(0), opt)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(
        size=(batch, NN_BENCHMARKS[name][0])).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=batch).astype(np.int32))
    step = exe.train_step(opt)
    return exe, lambda: step(state, {"x": x, "y": y})


@pytest.fixture
def calls(monkeypatch):
    """Calls of the executor's chunk kernels and the loss wrappers."""
    counts = dict.fromkeys(ops.KERNELS, 0)

    def spy(fn, name):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    names = ("fcnn_layer", "fcnn_layer_dgrad", "fcnn_layer_wgrad")
    monkeypatch.setattr(runtime, "_KERNEL_FNS", tuple(
        spy(f, n) for f, n in zip(runtime._KERNEL_FNS, names)))
    monkeypatch.setattr(ops, "_xent_fwd", spy(ops._xent_fwd,
                                              "softmax_xent_fwd"))
    monkeypatch.setattr(ops, "_xent_dlogits", spy(ops._xent_dlogits,
                                                  "softmax_xent_dlogits"))
    return counts


@pytest.mark.parametrize("name", ["NN1", "NN2", "NN5"])
def test_launches_equal_cpu_step_and_program(name, calls):
    batch = 16
    res = D.run_nn(name, batch)
    calls.update(dict.fromkeys(calls, 0))     # the dry-run's own, not counted
    exe, run = _cpu_step(name, batch, None)
    run()
    assert res["kernel_launches"] == calls
    degrees = res["program_degrees"]
    assert degrees == [r.degree for r in exe.program.runs("fp")]
    assert calls == {"fcnn_layer": sum(degrees),
                     "fcnn_layer_dgrad": sum(degrees[1:]),
                     "fcnn_layer_wgrad": sum(degrees),
                     "softmax_xent_fwd": 1, "softmax_xent_dlogits": 1,
                     "flash_attention": 0, "flash_attention_bwd": 0,
                     "ssd_chunk": 0, "ssd_chunk_bwd": 0}
    loss = cost.xent_fwd(batch, 10, 4).flops["float32"] \
        + cost.xent_dlogits(batch, 10, 4).flops["float32"]
    assert res["flops"] == sum(res["flops_per_device"]) + loss
    assert res["peak_memory_per_device"] > res["state_bytes"] > 0
    assert res["temp_gb"] > 0


@pytest.mark.parametrize("name", ["NN1", "NN4"])
def test_ref_mode_flops_equal_flop_counter_of_cpu_step(name):
    batch = 8
    _, counter = D.lower_nn(name, batch, 8, kernel_mode="ref")
    assert not counter.launches
    _, run = _cpu_step(name, batch, "ref")
    with FlopCounterMode(display=False) as fc:
        run()
    assert sum(counter.flops.values()) == fc.get_total_flops() > 0


def test_nn1_send_bytes():
    """NN1 ORRM on 8 devices, degrees 8/4/2: forward SENDs carry the
    (128, 1000) and (128, 500) activations, backward ones the partial
    input gradients of layers 3 (2 x (128, 500)) and 2 (4 x (128, 1000))."""
    exe = pexec.compile(workload("NN1", 128), onoc_config(64), 8,
                        strategy="orrm", device="meta")
    assert D.send_bytes(exe.program, 128) == \
        4 * 128 * (1000 + 500 + 2 * 500 + 4 * 1000)


def test_main_writes_every_cell(tmp_path):
    out = tmp_path / "f.json"
    assert D.main(["--batch", "8", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert sorted(res) == [f"{n}|train_b8|16x16|ring8" for n in NNS]
    assert all(r["ok"] and r["kernel_launches"]["fcnn_layer"] > 0
               for r in res.values())
