"""The LM training driver, the port's counterpart of the reference
``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      [--smoke] [--steps 50] [--batch 8] [--seq 128] [--lr 3e-4] \
      [--microbatches 1] [--grad-compression none|int8] \
      [--checkpoint-dir DIR] [--checkpoint-every 25] [--device cuda|cpu]

Trains a token LM of any registered arch of the hybrid, SSM, dense or MoE
family (the encoder-decoder and VLM archs are refused, as the reference
refuses them) on a seeded synthetic token stream (``data.token_stream``:
Zipf unigrams with bigram structure, so the loss can fall), through the
LM train step (``launch.steps.build_train_step``: the token loss on the
softmax cross-entropy kernels K4/K5 on the card, AdamW with fp32 moments,
clipping, optional microbatches and int8 error feedback) under the
``TrainingSupervisor``: an async checkpoint every ``--checkpoint-every``
steps, the parameters in the config's dtype (bf16 for the full configs),
and a restart from the latest complete checkpoint in ``--checkpoint-dir``
with the batcher's position, so a crashed run resumed in the same
directory takes the batches the uninterrupted run would have.  The
metrics go to host floats every step, as the reference's driver does.
The run reports the steps' time, the loss and the straggler count, and
exits non-zero when the last loss is not below the first.

The reference builds a mesh from the host's devices and shards the state
over it; the port trains on one device, the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import tempfile
import time
from typing import Any, Sequence

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ModelConfig, get_config, smoke_config
from repro_torch.data import Batcher, token_stream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (
    TrainSettings,
    build_train_step,
    init_train_state,
)
from repro_torch.models.api import get_model
from repro_torch.runtime import TrainingSupervisor

__all__ = ["TrainResult", "make_lm_data", "train", "main"]

log = logging.getLogger(__name__)

DEFAULT_CHECKPOINT_DIR = os.path.join(tempfile.gettempdir(),
                                      "repro_torch_ckpt")


def make_lm_data(cfg: ModelConfig, n_tokens: int, batch: int, seq: int,
                 device: torch.device | str) -> Batcher:
    """The reference's LM data: ``n_tokens // seq`` sequences of the seeded
    token stream, the labels the next token, batched on ``device``."""
    stream = token_stream(n_tokens + 1, cfg.vocab_size, seed=0)
    n_seqs = n_tokens // seq
    toks = stream[: n_seqs * seq].reshape(n_seqs, seq)
    labels = stream[1: n_seqs * seq + 1].reshape(n_seqs, seq)
    return Batcher({"tokens": toks, "labels": labels}, batch_size=batch,
                   device=device)


@dataclasses.dataclass
class TrainResult:
    """One driver run: the per-step metrics (``loss``, ``grad_norm`` as
    host floats, ``step``, ``seconds``), the wall time of the supervised
    loop, the steps that straggled, and the checkpoint step the run
    resumed from (None for a fresh start)."""
    cfg: ModelConfig
    history: list[dict]
    seconds: float
    straggler_steps: list[int]
    resumed_from: int | None


def train(arch: str, *, smoke: bool = False, steps: int = 50, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, microbatches: int = 1,
          grad_compression: str = "none",
          checkpoint_dir: str = DEFAULT_CHECKPOINT_DIR,
          checkpoint_every: int = 25,
          device: str | torch.device | None = None,
          cfg: ModelConfig | None = None,
          params: dict[str, Any] | None = None,
          checkpointer: Checkpointer | None = None) -> TrainResult:
    """Train ``arch`` (its smoke config where ``smoke``; ``cfg`` replaces
    either) for ``steps`` supervised steps on ``device`` (default the
    card), resuming from the latest checkpoint in ``checkpoint_dir``.

    The parameters are drawn from a generator seeded 0 on the device, or
    taken from ``params``, the reference's parameter pytree as numpy
    arrays (``params_from_numpy``); ``checkpointer`` replaces the
    ``Checkpointer(checkpoint_dir)`` the supervisor writes through."""
    cfg = cfg or (smoke_config(arch) if smoke else get_config(arch))
    if cfg.family in ("vlm", "encdec"):
        raise ValueError(
            "train.py drives token-LM archs; use examples/ for vlm/encdec")
    dev = resolve_device(device)
    model = get_model(cfg)
    settings = TrainSettings(learning_rate=lr, microbatches=microbatches,
                             grad_compression=grad_compression)
    step_fn = build_train_step(model, settings)

    def fresh_state():
        state = init_train_state(
            model, settings, torch.Generator(device=dev).manual_seed(0), dev)
        if params is not None:
            state["params"] = model.params_from_numpy(params, dev)
        return state

    batches = make_lm_data(cfg, batch * seq * (steps + 4), batch, seq, dev)
    sup = TrainingSupervisor(
        checkpointer or Checkpointer(checkpoint_dir),
        checkpoint_every=checkpoint_every)
    resumed_from = sup.latest()

    def wrapped(state, batch):
        state, metrics = step_fn(state, batch)
        return state, {k: float(v) for k, v in metrics.items()}

    t0 = time.perf_counter()
    # the fresh state is referenced by the supervisor alone, so a resume
    # frees it once the checkpoint is restored
    _, history = sup.run(fresh_state(), wrapped, batches, steps)
    seconds = time.perf_counter() - t0
    return TrainResult(cfg=cfg, history=history, seconds=seconds,
                       straggler_steps=list(sup.straggler.straggler_steps),
                       resumed_from=resumed_from)


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Train a token LM on a seeded synthetic stream with "
                    "checkpoint and restart.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config for this arch")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", choices=["none", "int8"],
                    default="none")
    ap.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    try:
        run = train(args.arch, smoke=args.smoke, steps=args.steps,
                    batch=args.batch, seq=args.seq, lr=args.lr,
                    microbatches=args.microbatches,
                    grad_compression=args.grad_compression,
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=args.checkpoint_every,
                    device=args.device)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    history, dt = run.history, run.seconds
    if not history:
        print(f"{run.cfg.name}: nothing to do, the checkpoint of step "
              f"{run.resumed_from} is at or past --steps {args.steps}")
        return 0
    losses = [h["loss"] for h in history]
    print(f"\n{run.cfg.name}: {len(history)} steps in {dt:.1f}s "
          f"({dt / max(1, len(history)):.3f}s/step)")
    print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
          f"min={min(losses):.4f}")
    print(f"stragglers observed: {len(run.straggler_steps)}")
    if losses[-1] >= losses[0]:
        raise SystemExit("loss did not decrease")
    return 0


if __name__ == "__main__":
    sys.exit(main())
