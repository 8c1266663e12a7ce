#!/usr/bin/env python3
"""Step 1 of a train cell of chip_smoke.py's phases 18d-18f on one CUDA
card, kernel path against plain path, beside the plain path's own noise:
the same weights (seed 0) on several seeded batches, each batch's loss on
the kernel path, on the plain path and on the plain path with its
attention as the reference's chunked attention at the reference's own
key chunk (``chip_smoke.chunked_plain_attention``, ``WITNESS_CHUNK``).
Each loss prints as a relative move from the plain path's, so the kernel
path's gap shows beside the plain path's own roundings; the largest move
over the batches sets the cell's fixed bars (``chip_smoke.TRAIN_FAMILIES``).
With ``--grads`` each path's step-1 gradients are taken too and the worst
leaves of both moves print (||g - g_plain|| / ||g_plain||).

  python3 tools/train_loss_noise.py --arch qwen2-vl-72b --seeds 1 2 3 4 5
  python3 tools/train_loss_noise.py --arch seamless-m4t-large-v2 --grads

``--arch`` names a ``chip_smoke.TRAIN_FAMILIES`` cell (its depth, batch
and microbatches); the MoE's plain path replays the kernel path's expert
choices (``chip_smoke.ExpertChoices``).  Prints one line per batch and the
card's name and power limit; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def main(argv=None) -> int:
    import torch

    import chip_smoke as S
    from repro_torch.launch.steps import TrainSettings, init_train_state
    from repro_torch.models.api import get_model

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default=S.VLM_ARCH,
                   choices=[ft.arch for ft in S.TRAIN_FAMILIES])
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    p.add_argument("--grads", action="store_true",
                   help="take each path's gradients and print the leaves")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ft = next(ft for ft in S.TRAIN_FAMILIES if ft.arch == args.arch)
    cfg = S.family_config(ft)
    model = get_model(cfg)
    settings = TrainSettings(microbatches=ft.microbatches)
    params = init_train_state(model, settings,
                              torch.Generator(device=dev).manual_seed(0),
                              dev)["params"]
    moe = cfg.family == "moe"
    for seed in args.seeds:
        batch = S.train_batch(torch, dev, cfg, ft.batch,
                              torch.Generator(device=dev).manual_seed(seed))
        choices = S.ExpertChoices()
        record = choices.record if moe else S.contextlib.nullcontext
        replay = choices.replay if moe else S.contextlib.nullcontext

        def step(mode, around):
            if args.grads:
                loss, grads = S.step_grads(model, params, batch,
                                           ft.microbatches, mode, around)
                return loss.item(), grads
            return S.step_loss(torch, model, params, batch, ft.microbatches,
                               mode, around), None

        kernel, g_kernel = step(None, record)
        plain, g_plain = step("ref", replay)
        with S.chunked_plain_attention():
            chunked, g_chunked = step("ref", replay)
        line = (f"{S.family_label(ft)} batch seed {seed}: plain loss "
                f"{plain:.7f}; kernel path {(kernel - plain) / plain:+.3e}; "
                f"the reference's chunked attention at {S.WITNESS_CHUNK} "
                f"keys {(chunked - plain) / plain:+.3e}")
        if args.grads:
            for what, g in (("kernel path", g_kernel),
                            ("chunked attention", g_chunked)):
                leaves = S.leaf_errors(g, g_plain)
                line += f"; leaves, {what}: " + ", ".join(
                    f"{p} {r:.3e}" for p, r in leaves[:4])
            del g_kernel, g_plain, g_chunked
            S.free_device_memory(torch)
        print(line, flush=True)
    print(S.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
