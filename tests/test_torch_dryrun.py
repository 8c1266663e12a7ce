"""The port's dry-run (``launch/dryrun.py``, ``hillclimb.py``) and what it
needs, against the JAX reference and against real CPU steps:

  * ``SHAPES``, ``LONG_CONTEXT_FAMILIES`` and ``shape_cells`` equal to the
    reference's for all 10 archs; ``param_count``, ``active_param_count``,
    ``model_flops`` for every arch x shape, ``optimized_plan`` and
    hillclimb's ``VARIANTS`` equal, key for key.  The reference's
    ``launch/dryrun.py`` and ``hillclimb.py`` set XLA_FLAGS to 512 host
    devices when imported, so they run in a subprocess (JSON out), never in
    this process;
  * ``train_state_spec`` (meta) leaf for leaf (keys, shapes, dtypes) the
    reference's ``jax.eval_shape`` of the train state, for every
    full-width config, with and without int8 compression; ``input_specs``
    equal for every family x kind;
  * ``kernels.cost`` giving PERF.md's bounds at five shapes, and K1's in
    case (b);
  * the dry-run at smoke width against a real CPU step of the same
    config, one per family, train, prefill and decode: with
    ``mode="ref"`` on both, the counted aten flops equal
    ``FlopCounterMode``'s count; with the default mode, the predicted
    K1-K7 launches equal the calls the CPU step makes to each wrapper
    (counted by a spy around the ``ops`` wrappers; ``launches`` stays 0
    on the CPU);
  * one full-width cell per family at ``decode_32k`` ends ``ok``, and
    granite-3-2b at ``train_4k`` ends ``ok: false`` at K4's 2**31-element
    limit; ``hillclimb`` marks a variant of rule overrides alone
    ``same_as: "baseline"``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import LONG_CONTEXT_FAMILIES as J_LONG
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs import shape_cells as j_shape_cells
from repro.launch import steps as JS
from repro.models.api import get_model as j_get_model
from repro_torch.configs import (
    LONG_CONTEXT_FAMILIES,
    SHAPES,
    ShapeSpec,
    get_config,
    list_archs,
    shape_cells,
    smoke_config,
)
from repro_torch.core.planner import H100Target
from repro_torch.kernels import cost, ops
from repro_torch.kernels.fcnn_layer import KernelLimitError
from repro_torch.kernels.softmax_xent import softmax_xent_fwd
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch import steps as S
from repro_torch.models.api import get_model

SRC = Path(__file__).resolve().parents[1] / "src"
# one smoke config a family
FAMILY_ARCHS = {"dense": "granite-3-2b", "moe": "qwen2-moe-a2.7b",
                "ssm": "mamba2-2.7b", "hybrid": "zamba2-1.2b",
                "encdec": "seamless-m4t-large-v2", "vlm": "qwen2-vl-72b"}
SMOKE_SHAPES = [ShapeSpec("smoke_train", 64, 2, "train"),
                ShapeSpec("smoke_prefill", 64, 2, "prefill"),
                ShapeSpec("smoke_decode", 64, 2, "decode")]

_REFERENCE = r"""
import json, sys
from repro.configs import SHAPES, get_config, list_archs
from repro.launch import dryrun, hillclimb
out = {"counts": {}, "plans": {}, "variants": hillclimb.VARIANTS}
for arch in list_archs():
    cfg = get_config(arch)
    out["counts"][arch] = {
        "param": dryrun.param_count(cfg),
        "active": dryrun.active_param_count(cfg),
        "model_flops": {s: dryrun.model_flops(cfg, SHAPES[s])
                        for s in SHAPES}}
for kind in ("train", "prefill", "decode"):
    for fam in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"):
        for kv in (0, 4, 8, 16):
            out["plans"][f"{kind}|{fam}|{kv}"] = dryrun.optimized_plan(
                kind, fam, kv)
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference():
    """The reference dry-run's pure functions, computed in a subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout)


def _json(x):
    return json.loads(json.dumps(x))


# ------------------------------------------------------------ copies

def test_shapes_and_cells_equal_reference():
    assert list_archs() == j_list_archs()
    assert LONG_CONTEXT_FAMILIES == J_LONG
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind, s.is_decode)
            for k, s in SHAPES.items()} == \
        {k: (s.name, s.seq_len, s.global_batch, s.kind, s.is_decode)
         for k, s in J_SHAPES.items()}
    for arch in list_archs():
        assert shape_cells(get_config(arch)) == \
            j_shape_cells(j_get_config(arch)), arch


def test_counts_plans_and_variants_equal_reference(reference):
    for arch in list_archs():
        cfg = get_config(arch)
        want = reference["counts"][arch]
        assert dryrun.param_count(cfg) == want["param"], arch
        assert dryrun.active_param_count(cfg) == want["active"], arch
        assert {s: dryrun.model_flops(cfg, SHAPES[s]) for s in SHAPES} == \
            want["model_flops"], arch
    for key, want in reference["plans"].items():
        kind, fam, kv = key.split("|")
        assert _json(dryrun.optimized_plan(kind, fam, int(kv))) == want, key
    assert _json(hillclimb.VARIANTS) == reference["variants"]


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, f"{prefix}/{i}"))
        return out
    assert tree.is_meta
    return {prefix: (tuple(tree.shape),
                     str(tree.dtype).removeprefix("torch."))}


def _ref_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "".join(f"/{getattr(p, 'key', getattr(p, 'idx', p))}"
                      for p in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_train_state_spec_equals_reference_eval_shape(compression):
    for arch in list_archs():
        got = S.train_state_spec(get_model(get_config(arch)),
                                 S.TrainSettings(grad_compression=compression))
        want = JS.train_state_spec(j_get_model(j_get_config(arch)),
                                   JS.TrainSettings(
                                       grad_compression=compression))
        assert _port_leaves(got) == _ref_leaves(want), arch


def test_input_specs_equal_reference():
    for arch in FAMILY_ARCHS.values():
        for name, shape in SHAPES.items():
            got = get_model(get_config(arch)).input_specs(shape)
            want = j_get_model(j_get_config(arch)).input_specs(J_SHAPES[name])
            assert _port_leaves(got) == _ref_leaves(want), (arch, name)


def test_cost_gives_perf_md_bounds():
    """PERF.md's bound column (ms, by): K6 at Zamba2's (1, 32, 2048, 64)
    bf16 causal 0.01738 (ops); K4 at granite's (2048, 49408) fp32 loss
    0.12083 (bytes); K7 at mamba2-2.7b's 16 chunks (128, 80, 64, 128) bf16
    0.02574 (bytes); K1 and K2 at NN5's batch of 128 with bf16 weights,
    their products counted as the tensor-core kernels run them: K1's layer
    1 (1024 -> 4000) in case (a) 0.00283 (bytes; the product once, 0.00108
    ms), K2's layer 2 (4000 -> 1000) in (a) 0.00285 (bytes; twice, dZ
    split: 0.00207); and, not in PERF.md, K1's layer 1 in case (b)
    0.00322 (bytes; twice, x split hi/lo: 0.00214)."""
    h100 = H100Target()
    for c, want, by in (
            (cost.fcnn_fwd(128, 1024, 4000, 2, 2), 0.00283, 1),
            (cost.fcnn_fwd(128, 1024, 4000, 4, 2), 0.00322, 1),
            (cost.fcnn_dgrad(128, 4000, 1000, 2, 2), 0.00285, 1),
            (cost.flash_attention(1, 32, 32, 2048, 2048, 64, 2, True),
             0.01738, 0),
            (cost.xent_fwd(2048, 49408, 4), 0.12083, 1),
            (cost.ssd_chunk(16, 128, 80, 64, 128, 1, 2), 0.02574, 1)):
        times = [t * 1e3 for t in c.seconds(h100)]
        assert times.index(max(times)) == by
        assert round(max(times), 5) == want


# ------------------------------------------------------ against a CPU step

def _cpu_inputs(cfg, shape, seed=0):
    """Model state and batch of the dry-run's cell, on the CPU, with
    values."""
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    model = get_model(cfg)
    batch = {}
    for k, spec in model.input_specs(shape).items():
        if k == "positions":
            t = torch.arange(spec.shape[-1], dtype=torch.int32)
            batch[k] = t.expand(*spec.shape).contiguous()
        elif spec.dtype == torch.int32:
            batch[k] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, size=spec.shape).astype(np.int32))
        else:
            batch[k] = torch.randn(spec.shape, generator=gen).to(spec.dtype)
    if shape.kind == "train":
        state = S.init_train_state(model, S.TrainSettings(), gen, "cpu")
        return model, state, batch
    params = model.init(gen, "cpu")
    if shape.kind == "prefill":
        return model, params, batch
    kw = {"enc_len": shape.seq_len // 2} if cfg.family == "encdec" else {}
    return model, (params, model.init_cache(shape.global_batch,
                                            shape.seq_len, "cpu", **kw)), batch


def _cpu_step(cfg, shape, mode):
    model, state, batch = _cpu_inputs(cfg, shape)
    if shape.kind == "train":
        return lambda: S.build_train_step(model, S.TrainSettings(),
                                          mode=mode)(state, batch)
    if shape.kind == "prefill":
        def run():
            with torch.inference_mode():
                return model.prefill(state, batch, shape.seq_len, mode=mode)
        return run

    def decode():
        with torch.inference_mode():
            return model.decode_step(*state, batch)
    return decode


@pytest.mark.parametrize("shape", SMOKE_SHAPES, ids=lambda s: s.kind)
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_dryrun_flops_equal_flop_counter_of_cpu_step(family, shape):
    cfg = smoke_config(FAMILY_ARCHS[family])
    counter = dryrun.lower_cell(cfg, shape, mode="ref")
    assert not counter.launches
    run = _cpu_step(cfg, shape, "ref")
    with FlopCounterMode(display=False) as fc:
        run()
    assert sum(counter.flops.values()) == fc.get_total_flops() > 0


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Calls each kernel wrapper gets through ``ops``, by kernel name."""
    calls = dict.fromkeys(ops.KERNELS, 0)
    for attr, name in (("_fcnn_fwd", "fcnn_layer"),
                       ("_fcnn_dgrad", "fcnn_layer_dgrad"),
                       ("_fcnn_wgrad", "fcnn_layer_wgrad"),
                       ("_xent_fwd", "softmax_xent_fwd"),
                       ("_xent_dlogits", "softmax_xent_dlogits"),
                       ("_flash_attention", "flash_attention"),
                       ("_flash_attention_bwd", "flash_attention_bwd"),
                       ("_ssd_chunk", "ssd_chunk"),
                       ("_ssd_chunk_bwd", "ssd_chunk_bwd")):
        fn = getattr(ops, attr)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, attr, spy)
    return calls


@pytest.mark.parametrize("shape", SMOKE_SHAPES, ids=lambda s: s.kind)
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_dryrun_launches_equal_wrapper_calls_of_cpu_step(family, shape,
                                                         wrapper_calls):
    cfg = smoke_config(FAMILY_ARCHS[family])
    res = dryrun.run_cell(FAMILY_ARCHS[family], shape, cfg=cfg)
    for name in ops.KERNELS:          # the dry-run's own calls, not counted
        wrapper_calls[name] = 0
    before = ops.launch_counts()
    _cpu_step(cfg, shape, None)()
    assert res["ok"] and res["kernel_launches"] == wrapper_calls
    assert ops.launch_counts() == before
    if shape.kind == "train":
        assert wrapper_calls["softmax_xent_fwd"] == 1
    elif shape.kind == "prefill":
        assert wrapper_calls["flash_attention"] + wrapper_calls["ssd_chunk"]


# ------------------------------------------------------------ full width

@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_full_width_decode_cell_ends_ok(family):
    res = dryrun.run_cell(FAMILY_ARCHS[family], "decode_32k")
    assert res["ok"] and res["mesh"] == "1xH100" and res["chips"] == 1
    assert res["collective_s"] == 0.0 and res["collectives"] == {}
    assert res["peak_memory_per_device"] > res["state_bytes"] > 0
    assert res["memory_s"] > 0 and res["compute_s"] > 0
    assert res["bottleneck"] == "memory"       # one token a row
    assert not any(res["kernel_launches"].values())


def test_full_width_train_cell_refused_at_k4_limit():
    """granite-3-2b's train_4k (256 x 4096 tokens on one card) is past
    K4's 32-bit limit with its logits, and past K6's with its attention's
    q (2^31 elements), which the step reaches first: the cell ends at K6's
    limit, and K4 refuses the logits it would get."""
    res = dryrun.run_cell("granite-3-2b", "train_4k")
    assert not res["ok"] and res["limit"]
    assert res["error"].startswith("KernelLimitError: flash_attention: q "
                                   "has 2147483648 elements")
    rows = SHAPES["train_4k"].global_batch * SHAPES["train_4k"].seq_len
    logits = torch.empty((rows, get_config("granite-3-2b").padded_vocab),
                         device="meta", dtype=torch.bfloat16)
    labels = torch.empty((rows,), device="meta", dtype=torch.int32)
    with pytest.raises(KernelLimitError, match="softmax_xent_fwd"):
        softmax_xent_fwd(logits, labels)


def test_hillclimb_marks_rule_only_variant(tmp_path):
    out = tmp_path / "h.json"
    hillclimb.main(["--arch", "zamba2-1.2b", "--shape", "decode_32k",
                    "--variants", "baseline,kv_rep,serve_bf16comm",
                    "--out", str(out)])
    res = json.loads(out.read_text())
    base, kv_rep, bf16 = (res[f"zamba2-1.2b|decode_32k|1xH100|{v}"]
                          for v in ("baseline", "kv_rep", "serve_bf16comm"))
    assert kv_rep["same_as"] == "baseline" and "same_as" not in bf16
    assert kv_rep["rules_not_applied"] == {"kv_heads": None,
                                           "activation_kv_heads": None}
    assert kv_rep["bytes_per_device"] == base["bytes_per_device"]
    assert bf16["ok"] and bf16["bytes_per_device"] < base["bytes_per_device"]
