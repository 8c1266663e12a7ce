"""Dry-run of every (architecture × input shape) cell on the meta device,
priced for one H100: the port's counterpart of the reference
``repro/launch/dryrun.py``, which lowers each cell onto a 256- or
512-chip TPU mesh of fake devices.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
      [--plan optimized] [--out results/dryrun_torch.json]

A cell builds its real step on meta tensors, which carry shapes and no
storage, so nothing is allocated on the card or the host:

  train    ``launch.steps.build_train_step`` on ``train_state_spec``;
  prefill  ``model.prefill`` of a ``seq_len`` prompt into a cache as deep;
  decode   ``model.init_cache`` at ``seq_len`` (an encoder-decoder's
           memory ``seq_len // 2``), then one ``decode_step``.

On meta the step follows the card's path: the kernel wrappers (K1–K7)
run their checks, return empty outputs and report each launch and its
``kernels.cost``; a bf16 product with fp32 output takes the card's
branch; a train cell's attention reports K6 with its lse and its SSD
K7 (each twice a layer under remat, which recomputes it), and the
backward of each once, as on the card.  ``CostCounter``, a
``TorchDispatchMode``, sees every aten op the step runs, autograd's
backward and the recompute of checkpointed layers included, and counts

  flops   each product through ``torch.utils.flop_counter``'s formulas,
          by its operands' dtype, plus each kernel's ``cost``;
  bytes   inputs and outputs of every op that moves data (not views,
          allocations or ops returning an alias of an input), plus each
          kernel's ``cost``;
  peak    live bytes: every storage created inside the counter, state
          and inputs included, rounded up to 512 bytes as the CUDA caching
          allocator rounds it, freed when its storage dies, and the
          temporary the card's softmax backward makes while it runs; the
          step's own
          peak (``step_peak_bytes``, the state live under it) beside the
          cell's, which includes making the state.

``compute_s`` sums each dtype's flops over the card's peak rate for it
(``core.planner.H100Target``), ``memory_s`` is bytes over HBM bandwidth;
one card moves nothing between chips, so ``collective_s`` is 0.  A cell
that a kernel wrapper refuses (a size past what the kernel indexes:
``kernels.fcnn_layer.KernelLimitError``) ends ``ok: false`` with that
error, as the reference records a cell that fails to lower.

Copied from the reference: ``param_count``, ``active_param_count``,
``model_flops``, ``optimized_plan`` and its tables.  ``--plan optimized``
applies the plan's config part; its sharding-rule part means nothing
without a mesh and is recorded as ``rules_not_applied``.  Not ported, on
purpose: ``_probe_correct``/``_lin`` and the config's ``probe_unroll``
(they correct XLA's cost analysis, which counts a scanned layer once; the
port's layers are a Python loop and the counter sees each one),
``collective_bytes_from_hlo`` (no HLO, no collectives on one card),
``_rules_for`` and ``launch/mesh.make_production_mesh`` (no mesh).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (
    SHAPES,
    ModelConfig,
    ShapeSpec,
    get_config,
    list_archs,
    shape_cells,
)
from repro_torch.core.planner import H100Target
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import ops
from repro_torch.kernels.fcnn_layer import KernelLimitError
from repro_torch.launch import steps as steps_lib
from repro_torch.models.api import get_model
from repro_torch.models.layers import use_accum_dtype

__all__ = ["MESH", "CostCounter", "count", "model_flops", "param_count",
           "active_param_count", "optimized_plan", "lower_cell", "run_cell",
           "cell_line", "main"]

MESH = "1xH100"
DEFAULT_OUT = "results/dryrun_torch.json"
META = torch.device("meta")

# ---------------------------------------------------------------- helpers


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n * tokens


def param_count(cfg: ModelConfig) -> float:
    """Total parameters (approximate closed form per family)."""
    d, l, v = cfg.d_model, cfg.n_layers, cfg.vocab_size
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family in ("dense", "vlm"):
        hd = cfg.resolved_head_dim
        attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
        mlp = 3 * d * cfg.d_ff
        return emb + l * (attn + mlp)
    if cfg.family == "moe":
        hd = cfg.resolved_head_dim
        attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
        moe = cfg.n_experts * 3 * d * cfg.moe_d_ff + d * cfg.n_experts
        shared = 3 * d * cfg.n_shared_experts * cfg.moe_d_ff
        return emb + l * (attn + moe + shared)
    if cfg.family == "ssm":
        di, g, n_s, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        proj = d * (2 * di + 2 * g * n_s + h) + di * d
        return emb + l * proj
    if cfg.family == "hybrid":
        di, g, n_s, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        mamba = d * (2 * di + 2 * g * n_s + h) + di * d
        hd = cfg.resolved_head_dim
        shared = (2 * d) * d + d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            + cfg.n_heads * hd * d + 3 * d * cfg.d_ff
        return emb + l * mamba + shared
    if cfg.family == "encdec":
        hd = cfg.resolved_head_dim
        attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
        mlp = 3 * d * cfg.d_ff
        enc = cfg.n_encoder_layers * (attn + mlp)
        dec = cfg.n_layers * (2 * attn + mlp)
        return emb + enc + dec
    raise ValueError(cfg.family)


def active_param_count(cfg: ModelConfig) -> float:
    """Active params per token (MoE: top-k of E experts)."""
    total = param_count(cfg)
    if cfg.family != "moe":
        return total
    d, l = cfg.d_model, cfg.n_layers
    all_experts = l * cfg.n_experts * 3 * d * cfg.moe_d_ff
    active_experts = l * cfg.experts_per_token * 3 * d * cfg.moe_d_ff
    return total - all_experts + active_experts


# The §Perf-winning recipes of the reference, applied by ``--plan
# optimized`` (its rules part recorded, not applied: no mesh here):
#   train/dense+vlm+ssm+hybrid+encdec — pure-FSDP layout + fused CE +
#     one-hot embed + chunked flash attention;
#   train/moe — kv-replication only where kv-heads don't divide the TP axis;
#   prefill — baseline;
#   decode/dense+vlm — 2D-TP weights, replicated per-token activations;
#   decode/ssm+hybrid+moe+encdec — baseline.
_TRAIN_PURE_FSDP = (
    {"activation_batch": ("pod", "data", "model"),
     "cache_batch": ("pod", "data", "model"),
     "activation_heads": None, "activation_kv_heads": None,
     "activation_mlp": None, "activation_vocab": None,
     "activation_exp": None, "kv_heads": None, "table_embed": None},
    {"attn_chunk_threshold": 2048 * 2048, "fused_ce": True,
     "embed_onehot": True},
)
_TRAIN_KV_REP = (
    {"kv_heads": None, "activation_kv_heads": None},
    {},
)
_DECODE_SERVE = (
    {"embed": None, "table_embed": None, "mlp": ("model", "data"),
     "activation_mlp": ("model", "data"), "activation_batch": None,
     "activation_vocab": ("model", "data"), "vocab": ("model", "data")},
    {},
)
_BASELINE = ({}, {})


def optimized_plan(kind: str, family: str,
                   n_kv_heads: int = 0, model_ways: int = 16
                   ) -> tuple[dict, dict]:
    if kind == "train":
        if family == "moe":
            # kv replication only pays when kv-heads don't divide the TP
            # axis (measured: 1.6× for granite-moe kv=8, 0.85× for
            # qwen2-moe kv=16)
            if n_kv_heads and n_kv_heads % model_ways != 0:
                return _TRAIN_KV_REP
            return _BASELINE
        return _TRAIN_PURE_FSDP
    if kind == "decode" and family in ("dense", "vlm"):
        return _DECODE_SERVE
    return _BASELINE


# ---------------------------------------------------------------- counting

_aten = torch.ops.aten
# allocations: no data moves
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_like.default,
               _aten.empty_strided.default, _aten.new_empty.default,
               _aten.new_empty_strided.default}
# ops that write their first argument without reading it
_WRITE_ONLY = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
               _aten.zero_.default, _aten.normal_.default,
               _aten.uniform_.default, _aten.random_.default}
# ops whose CUDA kernels allocate a temporary beside their output, which
# no meta output shows: softmax's backward forms grad * output first
# (softmax_backward_cuda_out; seen in the card's allocation trace), a
# tensor of the gradient's shape, written and read once more
_CUDA_TEMPS = {_aten._softmax_backward_data.default}
_prim_device = torch.ops.prim.device.default
ALLOC_ROUND = 512      # the CUDA caching allocator's block granularity


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _bytes(t: torch.Tensor) -> int:
    """Bytes a kernel moves for ``t``: its distinct elements (a broadcast,
    stride-0 dimension read once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


class CostCounter(TorchDispatchMode):
    """Counts what the ops run under it would cost the card (module
    docstring): ``flops`` by operand dtype and ``nbytes`` of aten ops,
    ``kernel_flops``/``kernel_bytes`` and ``launches`` of the kernels
    reported by their wrappers (a ``kernels.cost`` recorder), and
    ``live``/``peak`` bytes of the meta storages created under it (the
    card's memory; host tensors are left out), ``step_peak`` the peak since
    the last ``reset_work``."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._sizes: dict[int, int] = {}
        self.reset_work()

    def reset_work(self) -> None:
        """Zero the operation, traffic and launch counts and start
        ``step_peak`` from what is live (the memory is kept): what follows
        is the step."""
        self.step_peak = self.live
        self.flops: dict[str, float] = collections.defaultdict(float)
        self.nbytes = 0.0
        self.kernel_flops: dict[str, float] = collections.defaultdict(float)
        self.kernel_bytes = 0.0
        self.launches: collections.Counter = collections.Counter()

    # a kernels.cost recorder
    def kernel(self, name: str, cost: kcost.Cost) -> None:
        self.launches[name] += 1
        for dtype, f in cost.flops.items():
            self.kernel_flops[dtype] += f
        self.kernel_bytes += cost.nbytes

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def _transient(self, n: int) -> None:
        """``n`` bytes live beside the op's outputs while it runs."""
        self.peak = max(self.peak, self.live + n)
        self.step_peak = max(self.step_peak, self.live + n)

    def _track(self, outs: list[torch.Tensor]) -> None:
        for t in outs:
            st = t.untyped_storage()
            key, n = st._cdata, st.nbytes()
            if n and key not in self._sizes:
                n = -(-n // ALLOC_ROUND) * ALLOC_ROUND
                self._sizes[key] = n
                self.live += n
                self.peak = max(self.peak, self.live)
                self.step_peak = max(self.step_peak, self.live)
                weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry and func is not _prim_device:
            # a composite op (inference mode keeps aten.matmul whole): count
            # the ops it runs, as FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        # the card's tensors are the meta ones (a CPU tensor is host memory,
        # as a CPU draw moved to the device is)
        outs = [t for t in _tensors(out) if t.is_meta]
        self._track(outs)
        if func in _CUDA_TEMPS and outs:
            t = outs[0]
            self._transient(-(-t.numel() * t.element_size() // ALLOC_ROUND)
                            * ALLOC_ROUND)
            self.nbytes += 3 * _bytes(t)
        if not func.is_view and func not in _NO_TRAFFIC:
            ins = _tensors(args) + _tensors(kwargs)
            if func in _WRITE_ONLY:
                ins = ins[1:]
            ins = [t for t in ins if t.is_meta]
            in_keys = {t.untyped_storage()._cdata for t in ins}
            aliases = not func._schema.is_mutable and any(
                t.untyped_storage()._cdata in in_keys for t in outs)
            if not aliases:
                self.nbytes += sum(map(_bytes, ins)) + sum(map(_bytes, outs))
        if packet in flop_registry and _tensors(args)[0].is_meta:
            if func._overloadname == "dtype":   # mm/bmm(a, b, out_dtype)
                args, kwargs = args[:2], {}
            dtype = str(_tensors(args)[0].dtype).removeprefix("torch.")
            self.flops[dtype] += flop_registry[packet](*args, **kwargs,
                                                       out_val=out)
        return out

    def total_flops(self) -> dict[str, float]:
        out = collections.defaultdict(float, self.flops)
        for dtype, f in self.kernel_flops.items():
            out[dtype] += f
        return dict(out)

    def total_bytes(self) -> float:
        return self.nbytes + self.kernel_bytes


def count(setup: Callable[[], Any], step: Callable[[Any], Any]
          ) -> CostCounter:
    """Run ``step(setup())`` under a ``CostCounter``: the memory counts
    from the first allocation of ``setup`` (the state and the inputs), the
    operations, traffic and launches from the step alone.  Sets
    ``state_bytes`` (live after ``setup``) and ``step_s`` (host seconds of
    the step on meta)."""
    with CostCounter() as counter, kcost.recording(counter):
        inputs = setup()
        counter.state_bytes = counter.live
        counter.reset_work()
        t0 = time.perf_counter()
        step(inputs)
        counter.step_s = time.perf_counter() - t0
        del inputs
    return counter


# ---------------------------------------------------------------- lowering


def lower_cell(cfg: ModelConfig, shape: ShapeSpec,
               settings: steps_lib.TrainSettings | None = None,
               mode: str | None = None) -> CostCounter:
    """Count the cell's step (module docstring) on the meta device;
    ``mode`` is the kernels' (``ops.MODES``: ``"ref"`` runs the plain
    versions, as a comparison on the CPU does)."""
    model = get_model(cfg)
    gen = torch.Generator()

    if shape.kind == "train":
        settings = settings or steps_lib.TrainSettings()
        step = steps_lib.build_train_step(model, settings, mode=mode)

        def setup():
            return (steps_lib.train_state_spec(model, settings),
                    model.input_specs(shape))

        def run(args):
            return step(*args)
    elif shape.kind == "prefill":
        def setup():
            return model.init(gen, META), model.input_specs(shape)

        def run(args):
            with torch.inference_mode():
                return model.prefill(*args, shape.seq_len, mode=mode)
    else:
        kw = {"enc_len": shape.seq_len // 2} if cfg.family == "encdec" else {}

        def setup():
            return (model.init(gen, META),
                    model.init_cache(shape.global_batch, shape.seq_len, META,
                                     **kw),
                    model.input_specs(shape))

        def run(args):
            params, cache, batch = args
            with torch.inference_mode():
                return model.decode_step(params, cache, batch)

    with use_accum_dtype(cfg.accum_dtype):
        return count(setup, run)


def _shape(shape: str | ShapeSpec) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def run_cell(arch: str, shape: str | ShapeSpec,
             target: H100Target = H100Target(),
             cfg: ModelConfig | None = None,
             rule_overrides: dict | None = None,
             settings: steps_lib.TrainSettings | None = None,
             plan: str = "baseline") -> dict:
    """The cell's result: the reference's fields that mean something on
    one card, the kernels' launches and the state's bytes.  A cell a
    kernel wrapper refuses ends ``ok: false`` with its error; any other
    exception propagates."""
    shape = _shape(shape)
    cfg = cfg or get_config(arch)
    if plan == "optimized":
        rules_ov, cfg_ov = optimized_plan(shape.kind, cfg.family,
                                          cfg.n_kv_heads)
        rule_overrides = {**rules_ov, **(rule_overrides or {})}
        cfg = cfg.replace(**cfg_ov)
    head = {"arch": arch, "shape": shape.name, "mesh": MESH, "chips": 1,
            "rules_not_applied": dict(rule_overrides or {})}
    t0 = time.perf_counter()
    try:
        c = lower_cell(cfg, shape, settings)
    except KernelLimitError as e:
        return {**head, "ok": False, "limit": True,
                "error": f"{type(e).__name__}: {e}",
                "lower_s": round(time.perf_counter() - t0, 3)}
    flops = c.total_flops()
    flops_dev, bytes_dev = sum(flops.values()), c.total_bytes()
    compute_s, memory_s = kcost.Cost(flops, bytes_dev).seconds(target)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": 0.0}
    mf = model_flops(cfg, shape)
    return {
        **head,
        "flops_per_device": flops_dev,
        "flops_by_dtype": flops,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": 0.0,
        "collectives": {},
        **terms,
        "bottleneck": max(terms, key=terms.get).removesuffix("_s"),
        "model_flops": mf,
        "useful_flops_ratio": mf / flops_dev if flops_dev else 0.0,
        "peak_memory_per_device": float(c.peak),
        "step_peak_bytes": float(c.step_peak),
        "state_bytes": float(c.state_bytes),
        "fits": c.peak <= target.hbm_bytes,
        "kernel_launches": {name: c.launches[name] for name in ops.KERNELS},
        "lower_s": round(time.perf_counter() - t0, 3),
        "ok": True,
    }


def cell_line(res: dict, target: H100Target = H100Target()) -> str:
    """One printed line of a cell's result."""
    if res.get("skipped"):
        return f"skip: {res['reason']}"
    if not res.get("ok"):
        return f"FAIL ({'limit' if res.get('limit') else 'error'}): " \
               f"{res['error']}"
    return (f"ok: peak {res['peak_memory_per_device'] / 1e9:.3f} GB of "
            f"{target.hbm_bytes / 1e9:.0f}"
            f"{'' if res['fits'] else ' (does not fit)'}, compute "
            f"{res['compute_s'] * 1e3:.3f} ms, memory "
            f"{res['memory_s'] * 1e3:.3f} ms, bottleneck "
            f"{res['bottleneck']}, launches "
            f"{ {k: v for k, v in res['kernel_launches'].items() if v} } "
            f"({res['lower_s']} s)")


# ---------------------------------------------------------------- driver


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--plan", choices=["baseline", "optimized"],
                    default="baseline")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str, bool, str]] = []
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    for arch in archs:
        for shape_name, runnable, reason in shape_cells(get_config(arch)):
            if args.shape and shape_name != args.shape:
                continue
            cells.append((arch, shape_name, runnable, reason))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    t_all = time.perf_counter()
    for arch, shape_name, runnable, reason in cells:
        key = f"{arch}|{shape_name}|{MESH}"
        if not runnable:
            results[key] = {"arch": arch, "shape": shape_name, "mesh": MESH,
                            "ok": True, "skipped": True, "reason": reason}
            print(f"[skip] {key}: {reason}")
            continue
        if results.get(key, {}).get("ok") and \
                results[key].get("plan") == args.plan:
            print(f"[cached] {key}")
            continue
        print(f"[run] {key} ...", flush=True)
        try:
            res = run_cell(arch, shape_name, plan=args.plan)
        except Exception as e:  # noqa: BLE001 — recorded, the sweep goes on
            res = {"arch": arch, "shape": shape_name, "mesh": MESH,
                   "ok": False, "limit": False,
                   "error": f"{type(e).__name__}: {e}"}
            traceback.print_exc()
        res["plan"] = args.plan
        results[key] = res
        print(f"  {cell_line(res)}", flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results.values() if r.get("ok"))
    n_limit = sum(1 for r in results.values() if r.get("limit"))
    print(f"\n{n_ok}/{len(results)} cells ok, {n_limit} refused at a "
          f"kernel's limit, in {time.perf_counter() - t_all:.1f} s -> "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
