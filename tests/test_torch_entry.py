"""The port's entry points: device selection without a quiet fallback,
the trainer at full NN1 width and the Zamba2 serving CLI on the CPU, and
a package that never imports jax or the reference package."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train_fcnn

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_fails_without_cuda_unless_cpu_is_asked(no_cuda, capsys):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_fcnn.main(["--steps", "1"])
    assert train_fcnn.main(["--steps", "1", "--device", "cpu"]) == 0
    assert "final train accuracy" in capsys.readouterr().out


@pytest.mark.parametrize("strategy,residency", [("orrm", "sharded"),
                                                ("fm", "replicated")])
def test_program_mode_runs_on_cpu(strategy, residency, capsys):
    assert train_fcnn.main(["--program", "8", "--device", "cpu", "--steps",
                            "3", "--strategy", strategy, "--residency",
                            residency]) == 0
    out = capsys.readouterr().out
    assert (f"compiled {strategy.upper()} program (schema v2, {residency} "
            f"residency)") in out
    assert "cost contract: 6 RUN and 4 SEND costs equal simulate_epoch's" \
        in out
    assert f"residency ({residency}): peak" in out
    assert "final train accuracy" in out


def test_program_mode_fails_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_fcnn.main(["--program", "8", "--steps", "1"])


def test_train_program_learns_like_the_single_device_trainer():
    quiet = lambda _: None  # noqa: E731
    out = train_fcnn.train_program(arch=[64, 32, 10], steps=20, batch=16,
                                   device="cpu", n_samples=256, log=quiet)
    single = train_fcnn.train(arch=[64, 32, 10], steps=20, batch=16,
                              device="cpu", n_samples=256, log=quiet)
    assert out["executable"].program.n_devices == 8
    assert len(out["losses"]) == 20
    for a, b in zip(out["losses"], single["losses"]):
        assert a == pytest.approx(b, rel=1e-5)
    assert out["accuracy"] == pytest.approx(single["accuracy"], abs=1e-6)


def _serve_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "zamba2-1.2b", "--smoke", "--requests", "3", "--slots", "2", *args],
        env=env, capture_output=True, text=True, timeout=300)


def test_serve_cli_fails_without_cuda_unless_cpu_is_asked():
    res = _serve_cli()
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    res = _serve_cli("--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert "zamba2-1.2b-smoke · scenario=steady" in res.stdout
    assert "served 3/3 requests" in res.stdout


def test_serve_cli_in_process_writes_the_json_report(no_cuda, tmp_path,
                                                     capsys):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "zamba2-1.2b", "--smoke"])
    out = tmp_path / "report.json"
    assert serve_cli.main(["--arch", "zamba2-1.2b", "--smoke", "--device",
                           "cpu", "--scenario", "device-loss-mid-decode",
                           "--requests", "6", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "replan[device_loss] devices 1->1" in text
    report = json.loads(out.read_text())
    assert report["slo"]["n_finished"] == 6
    assert [r["reason"] for r in report["replans"]] == ["device_loss"]


def test_train_runs_full_width_nn1_on_cpu():
    out = train_fcnn.train(arch="NN1", steps=2, device="cpu",
                           log=lambda _: None)
    assert [p.onoc_cores for p in out["plan"].periods][0] == 1000
    assert len(out["losses"]) == 2
    assert all(torch.isfinite(torch.tensor(out["losses"])))
    assert 0.0 <= out["accuracy"] <= 1.0
    widths = [tuple(lp["w"].shape) for lp in out["params"]["layers"]]
    assert widths == [(784, 1000), (1000, 500), (500, 10)]


def test_port_imports_neither_jax_nor_the_reference_package():
    """In a fresh interpreter (this one has jax loaded already)."""
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.configs, "
        "repro_torch.data, repro_torch.kernels, repro_torch.kernels._build, "
        "repro_torch.models.fcnn, repro_torch.optim, "
        "repro_torch.launch.train_fcnn, repro_torch.models.api, "
        "repro_torch.exec, repro_torch.core.simulator, "
        "repro_torch.models.zamba2, repro_torch.serve, "
        "repro_torch.launch.serve, repro_torch.checkpoint, "
        "repro_torch.runtime, repro_torch.launch.elastic_restart, "
        "repro_torch.models.transformer, repro_torch.models.moe, "
        "repro_torch.models.tree, repro_torch.models.mamba2, "
        "repro_torch.models.encdec, repro_torch.models.vlm, "
        "repro_torch.parallel.gradsync, repro_torch.launch.steps, "
        "repro_torch.configs.nn_benchmarks\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_name_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not {"jax", "jaxlib", "repro"} & set(roots), (
            f"{path.name}:{node.lineno} imports {roots}")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the smoke script exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
