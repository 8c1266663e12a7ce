"""CPU tests of the benchmark's harness: names resolve to files, a cell,
a configuration and a metric are added by files and entries alone, the
result line's keys, the yardstick's counts against the program's, the
trace's reduction and the readers, and that nothing the harness imports
is JAX or the JAX package.  The tiny cells run the program's plain
versions on the CPU."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from bench import roofline
from bench.check import NUMBERS
from bench.harness import ROOT, Bench, main, run_cell
from bench.trace import breakdown, summary

from bench.test_bench_reference import (  # noqa: F401
    TINY,
    committed_config,
    tiny_root,
)


def test_every_name_resolves_to_its_files():
    bench = Bench()
    spec = bench.spec
    assert spec["paths"] == ["bench"]
    for c in spec["configs"]:
        cfg = bench.config(c["name"])
        assert c["file"].startswith("bench/configs/")
        assert cfg["source"] == c["source"]
        assert (ROOT / "bench" / "reference" /
                f"{cfg['reference']}.py").is_file()
    for w in spec["workloads"]:
        bench.config(w["config"])
        assert bench.traffic(w["traffic"])["kind"] == "train"
        limits = bench.limits(w["name"])
        assert set(limits) == set(NUMBERS)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.reader(m["name"]))
    names = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in names
    for w in spec["workloads"]:
        assert bench.metrics(w["name"], True), w["name"]
        assert len(bench.metrics(w["name"], False)) >= 2


def test_reduced_keys_are_the_changed_ones():
    """A key a configuration file runs at another value than its source's
    is listed in ``reduced``, and a listed key is one the file changes."""
    bench = Bench()
    for c in bench.spec["configs"]:
        cfg = bench.config(c["name"])
        changed = {k for k, v in cfg["source_values"].items() if cfg[k] != v}
        assert changed <= set(c["reduced"]), c["name"]
        assert set(c["reduced"]) <= set(cfg["source_values"]), c["name"]


def test_an_added_cell_and_metric_need_files_and_entries_only(tiny_root):
    """The tiny root adds a configuration, a traffic file, a cell's limits
    and a per-layer metric (``tiny_steps``) beside the committed ones, and
    edits no committed file; the added cell runs and its metric reads."""
    bench = Bench(tiny_root)
    for path in (ROOT / "bench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(ROOT)
            assert (tiny_root / rel).read_bytes() == path.read_bytes(), rel
    r = run_cell(bench, "tiny-dense.train", 11, 0.2, True, "cpu")
    assert r["metrics"]["tiny_steps"]["value"] == r["attempted"] > 0
    assert r["correct"], r["checks"]


def test_result_line_keys(tiny_root):
    r = run_cell(Bench(tiny_root), "tiny-moe.train", 12, 0.2, False, "cpu")
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}
    for name, row in r["checks"].items():
        assert set(row) == {"value", "limit"} and math.isfinite(row["value"])
    json.loads(json.dumps(r))


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = Bench().spec["workloads"][0]["name"]
    rc = main(["--workload", cell, "--seed", "1", "--seconds", "1",
               "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_run_exits_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = Bench().spec["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout == ""


def test_nothing_imports_jax_or_the_jax_package():
    """Importing every module of the benchmark loads no module whose
    top-level name is jax, jaxlib, flax or repro (``repro_torch`` is
    another name)."""
    readers = [m["name"] for m in Bench().spec["end_to_end"]
               + Bench().spec["per_layer"]]
    code = (
        "import sys\n"
        "import bench.harness, bench.program, bench.control, bench.trace\n"
        "import bench.roofline, bench.traffic, bench.check\n"
        "from bench.harness import Bench\n"
        "b = Bench()\n"
        f"[b.reader(n) for n in {readers!r}]\n"
        "b.reference('granite')\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'repro'))\n"
        "assert 'repro_torch' in sys.modules\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for path in (ROOT / "bench").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in (
                    "jax", "jaxlib", "flax", "repro"), (path, line)


# ----------------------------------------------------------- the yardstick

def test_parameter_counts():
    dense = committed_config("granite-3-2b")
    moe = committed_config("granite-moe-1b-a400m")
    assert roofline.param_count(dense) == 2_533_365_760
    assert roofline.param_count(moe) == 1_334_578_176
    assert roofline.active_param_count(moe) == 428_608_512


def test_counts_equal_the_programs():
    """The copies of ``launch/dryrun``'s parameter counts and of
    ``kernels/cost``'s work give the program's numbers at every timed
    shape."""
    from repro_torch.kernels import cost
    from repro_torch.launch import dryrun

    from bench.program import model_config

    bench = Bench()
    for w in bench.spec["workloads"]:
        cfg = bench.config(w["config"])
        tr = bench.traffic(w["traffic"])
        mc = model_config(cfg)
        assert roofline.param_count(cfg) == dryrun.param_count(mc)
        assert roofline.active_param_count(cfg) == \
            dryrun.active_param_count(mc)
        b = tr["batch"] // tr["microbatches"]
        att = (b, cfg["num_attention_heads"], cfg["num_key_value_heads"],
               tr["seq"], tr["seq"], cfg["head_dim"], 2, True)
        rows, vocab = b * tr["seq"], mc.padded_vocab
        for mine, theirs in (
                (roofline.flash_attention(*att), cost.flash_attention(*att)),
                (roofline.flash_attention_bwd(*att),
                 cost.flash_attention_bwd(*att)),
                (roofline.xent_fwd(rows, vocab, 4),
                 cost.xent_fwd(rows, vocab, 4)),
                (roofline.xent_dlogits(rows, vocab, 4),
                 cost.xent_dlogits(rows, vocab, 4))):
            assert mine.flops == theirs.flops
            assert mine.nbytes == theirs.nbytes


def test_step_flops():
    bench = Bench()
    cfg = committed_config("granite-3-2b")
    tr = bench.traffic("train-2x4096")
    attn = 12 * 40 * 2 * 32 * 64 * (4096 * 4097 // 2)
    assert roofline.train_step_flops(cfg, tr) == \
        6 * 2_533_365_760 * 8192 + attn
    moe = bench.config("granite-moe-1b-a400m")
    tr = bench.traffic("train-2x2048")
    flops = roofline.train_step_flops(moe, tr)
    assert 11.5e12 < flops < 12.0e12


# ------------------------------------------------------ trace and readers

class _Ev:
    def __init__(self, name, cuda, start, dur):
        self._n, self._c, self._s, self._d = name, cuda, start, dur

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._c else DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_trace_summary_busy_gaps_and_breakdown():
    us = 1000
    ev = [_Ev("bench.window", False, 0, 1000 * us),
          _Ev("bench.window", True, 0, 1000 * us),
          _Ev("aten::mm", False, 50 * us, 100 * us),
          _Ev("aten::add", False, 400 * us, 300 * us),
          _Ev("flash_fwd_wgmma_kernel", True, 100 * us, 200 * us),
          _Ev("flash_fwd_wgmma_kernel", True, 250 * us, 100 * us),
          _Ev("xent_dlogits_kernel", True, 800 * us, 5 * us),
          _Ev("xent_dlogits_kernel", True, 808 * us, 92 * us),
          _Ev("late_kernel", True, 2000 * us, 10 * us)]
    s = summary(ev)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((250 + 97) * 1e-6)
    assert s["device_ops"]["flash_fwd_wgmma_kernel"] == \
        (2, pytest.approx(300e-6))
    gaps = s["idle_gaps"]
    assert gaps["aten::mm"] == pytest.approx(100e-6)
    assert gaps["aten::add"] == pytest.approx(450e-6)
    assert gaps["gaps under 10 us"] == pytest.approx(3e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - s["busy_s"])
    b = breakdown(s)
    assert b["device_ops"][0][0] == "flash_fwd_wgmma_kernel"
    assert b["idle_gaps"][0][0] == "aten::add"
    assert summary(ev[:4]) is None


def _run(trace_ops: dict | None) -> dict:
    trace = None if trace_ops is None else {
        "busy_s": 8.0, "window_s": 10.0, "device_ops": trace_ops,
        "idle_gaps": {}}
    return {"config": committed_config("granite-3-2b"),
            "traffic": Bench().traffic("train-2x4096"), "setup_s": 30.0,
            "window": {"steps": 10, "seconds": 10.0, "tokens": 81920,
                       "dispatch_s": [0.3, 0.5, 0.4]},
            "peak_bytes": 4.1e10, "trace": trace}


def test_readers():
    bench = Bench()
    ops = {"void tc::flash_fwd_wgmma_kernel<64>()": (80, 0.02),
           "flash_bwd_prep_kernel": (40, 0.001),
           "void flash_bwd_wgmma_kernel()": (40, 0.02),
           "flash_bwd_dq_round_kernel": (40, 0.001),
           "xent_fwd_rows_kernel<float>": (1, 0.001),
           "xent_mean_kernel": (1, 0.0001),
           "xent_dlogits_kernel<float>": (1, 0.002),
           "ampere_sgemm": (1000, 5.0)}
    run = _run(ops)
    read = {m: bench.reader(m)(run) for m in (
        "train_tokens_per_s", "peak_mem_gb", "setup_s", "train_mfu_pct",
        "step_dispatch_ms", "device_idle_pct", "attn_roofline",
        "xent_roofline")}
    assert read["train_tokens_per_s"] == 8192
    assert read["peak_mem_gb"] == 41
    assert read["setup_s"] == 30
    assert read["step_dispatch_ms"] == pytest.approx(400)
    assert read["device_idle_pct"] == pytest.approx(20)
    cfg, tr = run["config"], run["traffic"]
    assert read["train_mfu_pct"] == pytest.approx(
        100 * roofline.train_step_flops(cfg, tr) / 989e12)
    att = (2, 32, 8, 4096, 4096, 64, 2, True)
    want = (80 * roofline.flash_attention(*att).bound_s()
            + 40 * roofline.flash_attention_bwd(*att).bound_s()) / 0.042
    assert read["attn_roofline"] == pytest.approx(100 * want)
    x = (8192, 49408, 4)
    want = (roofline.xent_fwd(*x).bound_s()
            + roofline.xent_dlogits(*x).bound_s()) / 0.0031
    assert read["xent_roofline"] == pytest.approx(100 * want)
    quiet = _run(None)
    for m in ("device_idle_pct", "attn_roofline", "xent_roofline"):
        assert bench.reader(m)(quiet) is None
    none = _run({"ampere_sgemm": (10, 1.0)})
    assert bench.reader("attn_roofline")(none) is None
    assert bench.reader("xent_roofline")(none) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", TINY)
def test_tiny_cell_on_card(card, tiny_root, cell):
    """The tiny cells through the port's kernels on the card."""
    r = run_cell(Bench(tiny_root), f"{cell}.train", 13, 0.5, True, card)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0


def test_judge_compares_every_number():
    from bench.check import judge

    numbers = {"loss_gap": 5e-3, "grad_gap": 0.1, "change_gap": 1e-2}
    limits = {"loss_gap": 1e-2, "grad_gap": 0.2, "change_gap": 2e-2}
    r = judge(numbers, limits)
    assert r["ok"] and r["rows"]["loss_gap"] == {"value": 5e-3,
                                                 "limit": 1e-2}
    for k in numbers:
        assert not judge(dict(numbers, **{k: 2 * limits[k]}), limits)["ok"]
    with pytest.raises(KeyError):
        judge(numbers, {k: v for k, v in limits.items() if k != "loss_gap"})
