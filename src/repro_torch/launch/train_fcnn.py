"""Train the paper's FCNN on the synthetic dataset with Adam, every period
through the port's kernels: the PyTorch counterpart of the single-device
mode of ``examples/train_fcnn_onoc.py``, at the benchmark's full width.

  PYTHONPATH=src python -m repro_torch.launch.train_fcnn \
      [--arch NN1] [--steps 300] [--batch 64] [--device cuda]

Prints the ONoC plan (Lemma-1 core counts per layer), the loss and
accuracy every 50 steps (the only host syncs of the loop), ms/step and
the final train accuracy, which must exceed 0.8 on a run of 300 steps or
more.  Without a GPU it exits with an error unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Sequence

import torch

from repro_torch.configs.nn_benchmarks import NN_BENCHMARKS
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.core.planner import plan_fcnn
from repro_torch.data import Batcher, fcnn_classification_dataset
from repro_torch.device import resolve_device
from repro_torch.models import fcnn
from repro_torch.optim import Optimizer, adam, linear_warmup_cosine

__all__ = ["train", "train_step", "main"]

FULL_RUN_STEPS = 300
ACCURACY_BAR = 0.8
LR = 3e-3
LOG_EVERY = 50


def train_step(params: dict, opt: Optimizer, opt_state: dict,
               batch: dict[str, torch.Tensor], step_t: torch.Tensor,
               kernel_mode: str | None = None) -> torch.Tensor:
    """One Adam step on ``batch``, updating ``params``, ``opt_state`` and
    the fp32 step counter ``step_t`` in place.  Returns the detached loss
    without reading it, so a step never waits for the device."""
    leaves = fcnn.parameters(params)
    loss = fcnn.loss_fn(params, batch, kernel_mode=kernel_mode)
    it = iter(torch.autograd.grad(loss, leaves))
    grads = {"layers": [{"w": next(it), "b": next(it)}
                        for _ in params["layers"]]}
    opt.update(grads, opt_state, params, step_t)
    step_t += 1.0
    return loss.detach()


def train(arch: str | Sequence[int] = "NN1", steps: int = FULL_RUN_STEPS,
          batch: int = 64, device: str | torch.device | None = None,
          seed: int = 0, kernel_mode: str | None = None,
          params: dict | None = None, warmup: int = 20,
          n_samples: int = 4096, log: Callable[[str], None] = print) -> dict:
    """Run the training loop; return ``{"losses", "accuracy",
    "ms_per_step", "plan", "params", "device"}``.

    ``arch`` is a name of ``NN_BENCHMARKS`` or explicit layer sizes.
    ``params`` (the reference's numpy pytree) replaces the seeded init.
    The dataset is ``fcnn_classification_dataset(n_samples, seed=0)``,
    batched as the reference's ``Batcher`` batches it.
    """
    dev = resolve_device(device)
    sizes = list(NN_BENCHMARKS[arch] if isinstance(arch, str) else arch)
    workload = FCNNWorkload(sizes, batch_size=batch)
    plan = plan_fcnn(workload, ONoCConfig(m=1000, lambda_max=64),
                     {"data": 1}, strategy="orrm")
    log("ONoC plan (per layer): "
        + ", ".join(f"L{p.period}: m*={p.onoc_cores} -> degree {p.degree}"
                    for p in plan.periods))

    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = fcnn.init(sizes, gen, dev)
    else:
        params = fcnn.params_from_numpy(params, dev)
    opt = adam(linear_warmup_cosine(LR, warmup, steps))
    opt_state = opt.init(params)

    x, y = fcnn_classification_dataset(n_samples, input_dim=sizes[0], seed=0)
    batches = Batcher({"x": x, "y": y}, batch_size=batch, device=dev)
    x_eval = batches.data["x"]
    y_eval = batches.data["y"]

    step_t = torch.zeros((), dtype=torch.float32, device=dev)
    losses = []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        losses.append(train_step(params, opt, opt_state, next(batches),
                                 step_t, kernel_mode))
        if i % LOG_EVERY == 0 or i == steps - 1:
            acc = fcnn.accuracy(params, x_eval[:1024], y_eval[:1024],
                                kernel_mode=kernel_mode)
            log(f"step {i:4d}  loss {float(losses[-1]):.4f}  "
                f"acc {float(acc):.3f}")
    _sync(dev)
    dt = time.perf_counter() - t0
    ms = 1e3 * dt / max(steps, 1)
    log(f"{steps} steps in {dt:.3f}s ({ms:.3f} ms/step) on {_name(dev)}")
    final_acc = float(fcnn.accuracy(params, x_eval, y_eval,
                                    kernel_mode=kernel_mode))
    log(f"final train accuracy: {final_acc:.3f}")
    return {
        "losses": torch.stack(losses).cpu().tolist() if losses else [],
        "accuracy": final_acc,
        "ms_per_step": ms,
        "plan": plan,
        "params": params,
        "device": dev,
    }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="NN1", choices=sorted(NN_BENCHMARKS))
    ap.add_argument("--steps", type=int, default=FULL_RUN_STEPS)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda, and fail if there is none")
    args = ap.parse_args(argv)
    out = train(arch=args.arch, steps=args.steps, batch=args.batch,
                device=args.device)
    if args.steps >= FULL_RUN_STEPS and out["accuracy"] <= ACCURACY_BAR:
        print(f"training failed to learn: accuracy {out['accuracy']:.3f} "
              f"<= {ACCURACY_BAR}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
