"""Hillclimb driver: run named experiment variants of one (arch × shape)
cell through the dry-run (``launch.dryrun.run_cell``, meta device, one
H100) and log the roofline terms and the peak per variant; the port's
counterpart of the reference ``repro/launch/hillclimb.py``.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \
      --arch granite-3-2b --shape train_4k \
      --variants baseline,dots,micro4,kv_rep,pure_fsdp+fce+oh+chunk

``VARIANTS`` is the reference's table, unchanged: each variant composes
sharding-rule overrides with config and ``TrainSettings`` overrides.  One
card has no mesh, so a variant's rule overrides are recorded as
``rules_not_applied`` and its config and settings overrides are run; a
variant made only of rule overrides runs the baseline and is marked
``same_as: "baseline"``.  The reference's ``--mesh`` is dropped.  Results
merge into ``--out`` (default ``results/hillclimb_torch.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Sequence

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.dryrun import MESH, cell_line, run_cell

__all__ = ["VARIANTS", "main"]

DEFAULT_OUT = "results/hillclimb_torch.json"

# each variant: (rule_overrides, cfg_overrides, settings_overrides)
VARIANTS: dict[str, tuple[dict, dict, dict]] = {
    "baseline": ({}, {}, {}),
    # vocab-parallel embedding: table sharded on vocab only — kills the
    # SPMD involuntary-full-remat on the token gather
    "vp_embed": ({"table_embed": None}, {}, {}),
    # remat policy: save matmul outputs (incl. post-collective tensors) so
    # the backward recompute repeats no collectives
    "dots": ({}, {"remat_policy": "dots"}, {}),
    "noremat": ({}, {"remat": False}, {}),
    # Megatron-SP: residual stream sequence-sharded on "model" between
    # blocks (AR -> RS+AG pairs, 1/16th resident activations)
    "seqpar": ({"residual_length": "model"}, {}, {}),
    # microbatched gradient accumulation (memory lever)
    "micro4": ({}, {}, {"microbatches": 4}),
    # int8 gradient compression (pod-axis gradient reduction 4x lighter)
    "int8grad": ({}, {}, {"grad_compression": "int8"}),
    # no FSDP: weights replicated over "data" (for small models the
    # per-layer weight all-gathers cost more than the memory saved)
    "nofsdp": ({"embed": None, "table_embed": None}, {}, {}),
    # combos
    "vp+seqpar": ({"table_embed": None, "residual_length": "model"}, {}, {}),
    "vp+nofsdp": ({"table_embed": None, "embed": None}, {}, {}),
    "vp+seqpar+nofsdp": ({"table_embed": None, "residual_length": "model",
                          "embed": None}, {}, {}),
    "vp+seqpar+micro4": ({"table_embed": None, "residual_length": "model"},
                         {}, {"microbatches": 4}),
    "vp+dots": ({"table_embed": None}, {"remat_policy": "dots"}, {}),
    "vp+seqpar+dots": ({"table_embed": None, "residual_length": "model"},
                       {"remat_policy": "dots"}, {}),
    # replicate GQA kv heads (8 does not divide model=16; uneven sharding
    # makes the attention backward all-gather FULL-BATCH K/V grads)
    "kv_rep": ({"kv_heads": None, "activation_kv_heads": None}, {}, {}),
    "kv_rep+dots": ({"kv_heads": None, "activation_kv_heads": None},
                    {"remat_policy": "dots"}, {}),
    "kv_rep+dots+micro4": ({"kv_heads": None, "activation_kv_heads": None},
                           {"remat_policy": "dots"}, {"microbatches": 4}),
    "kv_rep+micro4": ({"kv_heads": None, "activation_kv_heads": None},
                      {}, {"microbatches": 4}),
    # bf16 cross-shard partial sums / backward ARs (halves AR bytes)
    "kv_rep+bf16comm": ({"kv_heads": None, "activation_kv_heads": None},
                        {"accum_dtype": "bfloat16"}, {}),
    "kv_rep+bf16comm+micro4": (
        {"kv_heads": None, "activation_kv_heads": None},
        {"accum_dtype": "bfloat16"}, {"microbatches": 4}),
    "kv_rep+bf16comm+dots+micro4": (
        {"kv_heads": None, "activation_kv_heads": None},
        {"accum_dtype": "bfloat16", "remat_policy": "dots"},
        {"microbatches": 4}),
    "kv_rep+bf16comm+micro8": (
        {"kv_heads": None, "activation_kv_heads": None},
        {"accum_dtype": "bfloat16"}, {"microbatches": 8}),
    "kv_rep+vp+bf16comm+micro8": (
        {"kv_heads": None, "activation_kv_heads": None, "table_embed": None},
        {"accum_dtype": "bfloat16"}, {"microbatches": 8}),
    "kv_rep+bf16comm+dots+micro8": (
        {"kv_heads": None, "activation_kv_heads": None},
        {"accum_dtype": "bfloat16", "remat_policy": "dots"},
        {"microbatches": 8}),
    "kv_rep+bf16comm+dots+micro4b": (
        {"kv_heads": None, "activation_kv_heads": None},
        {"accum_dtype": "bfloat16", "remat_policy": "dots"},
        {"microbatches": 4}),
    # pure FSDP: batch over data*model (1 seq/device at train_4k), weights
    # stay 2D-sharded and are gathered per layer; NO tensor-parallel
    # activations so the Megatron activation all-reduces vanish entirely
    "pure_fsdp": (
        {"activation_batch": ("pod", "data", "model"),
         "cache_batch": ("pod", "data", "model"),
         "activation_heads": None, "activation_kv_heads": None,
         "activation_mlp": None, "activation_vocab": None,
         "activation_exp": None, "kv_heads": None},
        {}, {}),
    "pure_fsdp+vp": (
        {"activation_batch": ("pod", "data", "model"),
         "cache_batch": ("pod", "data", "model"),
         "activation_heads": None, "activation_kv_heads": None,
         "activation_mlp": None, "activation_vocab": None,
         "activation_exp": None, "kv_heads": None, "table_embed": None},
        {}, {}),
    "pure_fsdp+vp+bf16comm": (
        {"activation_batch": ("pod", "data", "model"),
         "cache_batch": ("pod", "data", "model"),
         "activation_heads": None, "activation_kv_heads": None,
         "activation_mlp": None, "activation_vocab": None,
         "activation_exp": None, "kv_heads": None, "table_embed": None},
        {"accum_dtype": "bfloat16"}, {}),
    # pure FSDP but logits stay vocab-sharded + chunked attention at 4k
    "pure_fsdp+vTP+chunk": (
        {"activation_batch": ("pod", "data", "model"),
         "cache_batch": ("pod", "data", "model"),
         "activation_heads": None, "activation_kv_heads": None,
         "activation_mlp": None,
         "activation_exp": None, "kv_heads": None, "table_embed": None},
        {"attn_chunk_threshold": 2048 * 2048}, {}),
    "pure_fsdp+vTP+chunk+bf16comm": (
        {"activation_batch": ("pod", "data", "model"),
         "cache_batch": ("pod", "data", "model"),
         "activation_heads": None, "activation_kv_heads": None,
         "activation_mlp": None,
         "activation_exp": None, "kv_heads": None, "table_embed": None},
        {"attn_chunk_threshold": 2048 * 2048, "accum_dtype": "bfloat16"},
        {}),
    "pure_fsdp+fce+chunk": (
        {"activation_batch": ("pod", "data", "model"),
         "cache_batch": ("pod", "data", "model"),
         "activation_heads": None, "activation_kv_heads": None,
         "activation_mlp": None, "activation_vocab": None,
         "activation_exp": None, "kv_heads": None, "table_embed": None},
        {"attn_chunk_threshold": 2048 * 2048, "fused_ce": True}, {}),
    "pure_fsdp+fce+chunk+bf16comm": (
        {"activation_batch": ("pod", "data", "model"),
         "cache_batch": ("pod", "data", "model"),
         "activation_heads": None, "activation_kv_heads": None,
         "activation_mlp": None, "activation_vocab": None,
         "activation_exp": None, "kv_heads": None, "table_embed": None},
        {"attn_chunk_threshold": 2048 * 2048, "fused_ce": True,
         "accum_dtype": "bfloat16"}, {}),
    "pure_fsdp+fce+oh+chunk": (
        {"activation_batch": ("pod", "data", "model"),
         "cache_batch": ("pod", "data", "model"),
         "activation_heads": None, "activation_kv_heads": None,
         "activation_mlp": None, "activation_vocab": None,
         "activation_exp": None, "kv_heads": None, "table_embed": None},
        {"attn_chunk_threshold": 2048 * 2048, "fused_ce": True,
         "embed_onehot": True}, {}),
    # serving layout: weights 2D-TP (mlp over model*data), nothing gathered
    # per step; decode activations are tiny so resharding them is free
    "serve_2dtp": (
        {"embed": None, "table_embed": None, "mlp": ("model", "data")},
        {}, {}),
    "serve_2dtp+bf16comm": (
        {"embed": None, "table_embed": None, "mlp": ("model", "data")},
        {"accum_dtype": "bfloat16"}, {}),
    "serve_bf16comm": ({}, {"accum_dtype": "bfloat16"}, {}),
    # + replicate decode activations (tiny); h replicated x 2D-sharded W
    # has no sharding conflict, so nothing is gathered at all
    "serve_2dtp_repb": (
        {"embed": None, "table_embed": None, "mlp": ("model", "data"),
         "activation_mlp": ("model", "data"), "activation_batch": None,
         "activation_vocab": ("model", "data"), "vocab": ("model", "data")},
        {}, {}),
    "pure_fsdp+vTP+chunk+micro2": (
        {"activation_batch": ("pod", "data", "model"),
         "cache_batch": ("pod", "data", "model"),
         "activation_heads": None, "activation_kv_heads": None,
         "activation_mlp": None,
         "activation_exp": None, "kv_heads": None, "table_embed": None},
        {"attn_chunk_threshold": 2048 * 2048}, {"microbatches": 2}),
}


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for variant in args.variants.split(","):
        rules_ov, cfg_ov, set_ov = VARIANTS[variant]
        key = f"{args.arch}|{args.shape}|{MESH}|{variant}"
        if results.get(key, {}).get("ok"):
            print(f"[cached] {key}")
            continue
        print(f"[run] {key}", flush=True)
        cfg = get_config(args.arch)
        if cfg_ov:
            cfg = cfg.replace(**cfg_ov)
        settings = steps_lib.TrainSettings(**set_ov) if set_ov else None
        t0 = time.perf_counter()
        try:
            res = run_cell(args.arch, args.shape, cfg=cfg,
                           rule_overrides=rules_ov, settings=settings)
        except Exception as e:  # noqa: BLE001 — recorded, the sweep goes on
            res = {"ok": False, "limit": False,
                   "error": f"{type(e).__name__}: {e}"}
        res["variant"] = variant
        if variant != "baseline" and not cfg_ov and not set_ov:
            res["same_as"] = "baseline"
        results[key] = res
        print(f"  {cell_line(res)} ({time.perf_counter() - t0:.1f} s)"
              f"{' same_as baseline' if 'same_as' in res else ''}",
              flush=True)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
