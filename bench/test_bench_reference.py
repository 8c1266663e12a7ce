"""CPU tests of the plain reference and of the check that decides
``correct``, on tiny Granite configurations (dense and MoE) beside the
committed ones: the reference against ``repro_torch``'s train step in fp32
(the same arithmetic but for the order of sums), the bf16 program within
the tiny cells' limits, the fp8 control and the planted faults outside
them.

The tiny cells' limits were set from these CPU readings (the program in
bf16 on the plain versions against the fp32 reference, seeds 1-3 and
2**31 + 5: loss_gap 1e-5-3e-5, grad_gap 3.9e-4-4.8e-3, change_gap
5.9e-4-1.2e-3; the fp8 control, seeds 1-3: loss_gap 9e-5-1.9e-4,
grad_gap 1.1e-2-2.7e-2, change_gap 3.1e-3-9.5e-3)."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from bench.check import NUMBERS, judge
from bench.control import readings
from bench.harness import ROOT, Bench, run_cell
from bench.program import TrainProgram

TINY = ("tiny-dense", "tiny-moe")
TINY_LIMITS = {"loss_gap": 6e-5, "grad_gap": 8e-3, "change_gap": 2e-3}
FP32_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 5e-5}

def committed_config(name: str) -> dict:
    """A configuration file under ``bench/configs/``, whether or not a cell
    of ``BENCHMARK.json`` runs it."""
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())


TINY_STEPS = '''"""Steps in the window: a per-layer metric added by a file."""


def read(run):
    return run["window"]["steps"]
'''


def _tiny_config(base: dict, name: str, moe: bool, dtype: str) -> dict:
    cfg = dict(base, name=name, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               attention_multiplier=0.25, vocab_size=256,
               intermediate_size=32 if moe else 128)
    cfg["run"] = dict(base["run"], param_dtype=dtype, compute_dtype=dtype)
    if moe:
        # the coefficient the tiny limits were set at
        cfg.update(num_local_experts=8, num_experts_per_tok=2,
                   router_aux_loss_coef=0.01)
        cfg["run"]["moe_group_size"] = 32
    return cfg


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout's benchmark with tiny cells added by files and entries:
    configurations (bf16, and fp32 twins), a traffic file, each cell's
    limits and a per-layer metric of their own."""
    root = tmp_path_factory.mktemp("bench_root")
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = Bench()
    cells = []
    for fam, base in (("dense", "granite-3-2b"),
                      ("moe", "granite-moe-1b-a400m")):
        for suffix, dtype, limits in (("", "bfloat16", TINY_LIMITS),
                                      ("-fp32", "float32", FP32_LIMITS)):
            name = f"tiny-{fam}{suffix}"
            cfg = _tiny_config(committed_config(base), name, fam == "moe",
                               dtype)
            (root / "bench" / "configs" / f"{name}.json").write_text(
                json.dumps(cfg))
            spec["configs"].append({
                "name": name, "source": cfg["source"],
                "file": f"bench/configs/{name}.json", "reduced": [],
                "why": "tiny"})
            cell = f"{name}.train"
            cells.append(cell)
            spec["workloads"].append({"name": cell, "config": name,
                                      "traffic": "tiny", "chips": 1,
                                      "why": "tiny"})
            (root / "bench" / "cells" / f"{cell}.json").write_text(
                json.dumps({"limits": limits}))
    traffic = dict(bench.traffic("train-2x2048"), batch=4, seq=64,
                   microbatches=2, pool=8)
    (root / "bench" / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    (root / "bench" / "metrics" / "tiny_steps.py").write_text(TINY_STEPS)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += cells
    spec["per_layer"].append({
        "name": "tiny_steps", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "driver",
        "moves": "train_tokens_per_s", "workloads": cells})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.mark.parametrize("cell", TINY)
def test_reference_is_the_programs_step_in_fp32(tiny_root, cell):
    """Three steps of the port's train step and of the reference from the
    same parameters and batches, both in fp32: the same arithmetic."""
    r = run_cell(Bench(tiny_root), f"{cell}-fp32.train", 5, 0.1, False, "cpu")
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
@pytest.mark.parametrize("cell", TINY)
def test_bf16_program_is_correct(tiny_root, cell, seed):
    r = run_cell(Bench(tiny_root), f"{cell}.train", seed, 0.1, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", TINY)
def test_control_is_not_correct(tiny_root, cell, seed):
    """The reference in fp8, in the program's place, fails a limit; the
    half-batch fault planted in the reference fails one too."""
    out = readings(Bench(tiny_root), f"{cell}.train", seed, "cpu")
    for kind in ("control", "half_batch"):
        assert not judge(out[kind], TINY_LIMITS)["ok"], (kind, out[kind])


def _unchanged(self, batch):
    """The fault of a step that returns its state unchanged: the loss and
    its gradients, no update."""
    loss = self.model.loss_fn(self.state["params"], batch)
    return loss.detach(), torch.ones(())


def _half_batch(self, batch, step=TrainProgram.step):
    """The fault of a step that takes the mean over half its batch."""
    return step(self, {k: v[: v.shape[0] // 2] for k, v in batch.items()})


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TINY)
def test_broken_step_is_not_correct(tiny_root, monkeypatch, cell, fault):
    """A run with the timed path broken underneath reads correct false."""
    monkeypatch.setattr(TrainProgram, "step", fault)
    r = run_cell(Bench(tiny_root), f"{cell}.train", 1, 0.1, False, "cpu")
    assert not r["correct"]
    assert not judge({k: r["checks"][k]["value"] for k in NUMBERS},
                     TINY_LIMITS)["ok"]
