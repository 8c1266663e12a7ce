#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Builds the five CUDA kernels of the FCNN training step from
``src/repro_torch/kernels/csrc`` and drives the port's main path, the
paper's NN1 (784-1000-500-10) trained with Adam, through the port's own
entry point.  Phases, each printing its own lines; any failure raises and
the script exits non-zero without a result line:

  1. device   a CUDA card is required; its name and power limit; TF32 off
  2. build    the extension, with ptxas's per-kernel resource report
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the NN1 and NN5 shapes and at edge shapes, with times of the
              kernel, the plain version and one PyTorch library call
  4. autograd gradients of the fused ops on NN1 against autograd of the
              plain versions
  5. train    NN1, 300 steps, batch 64, seed 0, through
              ``repro_torch.launch.train_fcnn.train``; accuracy > 0.8 and
              every kernel launched (launch counters reset just before);
              then a profiled window of 50 steps: device busy time per
              step and the top device operations
  6. nn5      5 steps of NN5 at batch 128, kernel path against plain path
              from the same seed; losses within 1e-4

The last three lines are a JSON object of per-kernel numbers, the card's
name and power limit as nvidia-smi reports them, and the result object.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data-sheet peaks: HBM bandwidth and fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

GEMM_RTOL = 1e-4    # fp32 sums of up to 4000 terms in another order
XENT_ATOL = 1e-5    # nll, lse, dlogits

NN1 = [784, 1000, 500, 10]
NN5 = [1024, 4000, 1000, 4000, 10]
ACTS = ("sigmoid", "relu", "tanh", "none")

KERNEL_INFO = {
    # name: (source, TPU kernel it replaces)
    "fcnn_layer": ("src/repro_torch/kernels/csrc/fcnn_layer.cu",
                   "src/repro/kernels/fcnn_layer.py:142"),
    "fcnn_layer_dgrad": ("src/repro_torch/kernels/csrc/fcnn_layer.cu",
                         "src/repro/kernels/fcnn_layer.py:208"),
    "fcnn_layer_wgrad": ("src/repro_torch/kernels/csrc/fcnn_layer.cu",
                         "src/repro/kernels/fcnn_layer.py:292"),
    "softmax_xent_fwd": ("src/repro_torch/kernels/csrc/softmax_xent.cu",
                         "src/repro/kernels/softmax_xent.py:111"),
    "softmax_xent_dlogits": ("src/repro_torch/kernels/csrc/softmax_xent.cu",
                             "src/repro/kernels/softmax_xent.py:172"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_T0 = time.perf_counter()


def phase(n: int | str, name: str) -> None:
    print(f"\n=== phase {n}: {name}  (t = {time.perf_counter() - _T0:.1f} s)",
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- measuring


def eager_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time per call of ``fn`` called back to back, from CUDA events:
    the larger of its device time and its host cost (Python, checks,
    launch), as an eager training loop sees it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_rows(prof) -> list[tuple[str, int, float]]:
    """(name, count, µs) of every device operation a profiler recorded."""
    from torch.autograd import DeviceType

    return [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def device_ms(fn, iters: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    cost per call drops out (inputs warm in L2, as between the periods of
    a training step)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of bytes over the HBM rate and fp32
    operations over the fp32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def errors(out, ref) -> tuple[float, float]:
    """(max abs error, max abs error over max |ref|)."""
    abs_err = (out.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return abs_err, abs_err / max(scale, 1e-30)


# --------------------------------------------------------------- phase 3


def kernel_cases(torch, dev, gen):
    """Yield (kernel name, label, kernel call, plain call, library call,
    bytes, flops, timed, on the NN1 step) for every comparison of phase 3.
    Bytes count each input read once and each output written once; flops
    count the product's multiply-adds as 2 and each element-wise step
    as 1."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fcnn_layer import (
        fcnn_layer,
        fcnn_layer_dgrad,
        fcnn_layer_wgrad,
    )
    from repro_torch.kernels.softmax_xent import (
        softmax_xent_dlogits,
        softmax_xent_fwd,
    )
    F = torch.nn.functional
    lib_act = {"sigmoid": torch.sigmoid, "relu": torch.relu,
               "tanh": torch.tanh, "none": lambda z: z}

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def layer_cases(tag, sizes, batch, acts_for=None, timed=True,
                    on_path=False):
        l = len(sizes) - 1
        for i in range(l):
            k, n = sizes[i], sizes[i + 1]
            acts = acts_for or (("sigmoid",) if i < l - 1 else ("none",))
            for act in acts:
                m = batch
                x, w = rand(m, k), rand(k, n, scale=k ** -0.5)
                b, dy = rand(n, scale=0.1), rand(m, n, scale=0.01)
                y = ref.fcnn_layer_ref(x, w, b, act)
                dz = ref.act_deriv_from_output(y, act) * dy
                lab = f"{tag} L{i + 1} {m}x{k}x{n} {act}"
                # the step skips dgrad of layer 1 (its input needs no grad)
                yield ("fcnn_layer", lab,
                       lambda x=x, w=w, b=b, a=act: fcnn_layer(x, w, b, a),
                       lambda x=x, w=w, b=b, a=act: ref.fcnn_layer_ref(x, w, b, a),
                       lambda x=x, w=w, b=b, a=act: lib_act[a](torch.addmm(b, x, w)),
                       4 * (m * k + k * n + n + m * n), 2 * m * k * n + 2 * m * n,
                       timed, on_path)
                yield ("fcnn_layer_dgrad", lab,
                       lambda dy=dy, y=y, w=w, a=act: fcnn_layer_dgrad(dy, y, w, a),
                       lambda dy=dy, y=y, w=w, a=act: ref.fcnn_layer_dgrad_ref(dy, y, w, a),
                       lambda dz=dz, w=w: dz @ w.T,
                       4 * (2 * m * n + k * n + m * k), 2 * m * n * k + 2 * m * n,
                       timed, on_path and i > 0)
                yield ("fcnn_layer_wgrad", lab,
                       lambda x=x, dy=dy, y=y, a=act: fcnn_layer_wgrad(x, dy, y, a),
                       lambda x=x, dy=dy, y=y, a=act: ref.fcnn_layer_wgrad_ref(x, dy, y, a),
                       lambda x=x, dz=dz: (x.T @ dz, dz.sum(0)),
                       4 * (m * k + 2 * m * n + k * n + n), 2 * m * k * n + 3 * m * n,
                       timed, on_path)

    def xent_cases(tag, b, c, timed=True, on_path=False):
        x = rand(b, c, scale=3.0)
        lab = torch.randint(0, c, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
        lab64 = lab.long()
        onehot = F.one_hot(lab64, c).float()
        nll, lse = ref.softmax_xent_fwd_ref(x, lab)
        scale = torch.full((b,), 0.7 / b, device=dev)
        label = f"{tag} {b}x{c}"
        yield ("softmax_xent_fwd", label,
               lambda: softmax_xent_fwd(x, lab),
               lambda: ref.softmax_xent_fwd_ref(x, lab),
               lambda: F.cross_entropy(x, lab64, reduction="none"),
               4 * (b * c + 3 * b), 4 * b * c, timed, on_path)
        yield ("softmax_xent_dlogits", label,
               lambda: softmax_xent_dlogits(x, lab, lse, scale),
               lambda: ref.softmax_xent_dlogits_ref(x, lab, lse, scale),
               lambda: torch.softmax(x, -1) - onehot,
               4 * (2 * b * c + 3 * b), 4 * b * c, timed, on_path)

    yield from layer_cases("NN1", NN1, 64, on_path=True)
    yield from xent_cases("NN1", 64, 10, on_path=True)
    yield from layer_cases("NN5", NN5, 128)
    yield from xent_cases("NN5", 128, 10)
    # edges: batch 1, N = 10, K = 784, every activation
    yield from layer_cases("edge", [784, 10], 1, acts_for=ACTS, timed=False)
    yield from layer_cases("edge", NN1[:2], 64, acts_for=ACTS, timed=False)
    yield from xent_cases("edge", 1, 10, timed=False)
    yield from xent_cases("edge", 37, 300, timed=False)


def run_kernel_phase(torch, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "library_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
                      "ops_ms": 0.0, "shapes": []}
               for name in KERNEL_INFO}
    for (name, label, kern, plain, lib, nbytes, flops, timed,
         on_path) in kernel_cases(torch, dev, gen):
        out, want = kern(), plain()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        wants = want if isinstance(want, tuple) else (want,)
        worst_abs = worst_rel = 0.0
        for o, w in zip(outs, wants):
            a, r = errors(o, w)
            worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        gemm = name.startswith("fcnn")
        ok = worst_rel <= GEMM_RTOL if gemm else worst_abs <= XENT_ATOL
        tol = f"rel<={GEMM_RTOL:g}" if gemm else f"abs<={XENT_ATOL:g}"
        line = (f"{name:21s} {label:32s} max_abs {worst_abs:.3e} "
                f"max_rel {worst_rel:.3e} ({tol}) {'ok' if ok else 'FAIL'}")
        s = summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], worst_abs)
        if timed:
            ms, plain_ms, lib_ms = (device_ms(kern), device_ms(plain),
                                    device_ms(lib))
            b_ms, b_by = bound(nbytes, flops)
            line += (f" | device ms: kernel {ms:.5f} plain {plain_ms:.5f} "
                     f"library {lib_ms:.5f} bound {b_ms:.5f} ({b_by}) | "
                     f"eager ms: kernel {eager_ms(kern):.5f} plain "
                     f"{eager_ms(plain):.5f}"
                     f"{' [NN1 step]' if on_path else ''}")
            if on_path:
                s["ms"] += ms
                s["plain_ms"] += plain_ms
                s["library_ms"] += lib_ms
                s["bound_ms"] += b_ms
                s["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
                s["ops_ms"] += flops / FP32_FLOP_PER_S * 1e3
                s["shapes"].append(label)
        print(line, flush=True)
        check(ok, f"{name} {label} disagrees with its plain version")
    return summary


# --------------------------------------------------------------- phase 4


def run_autograd_phase(torch, dev) -> None:
    from repro_torch.data import fcnn_classification_dataset
    from repro_torch.models import fcnn

    gen = torch.Generator().manual_seed(1)
    params = fcnn.init(NN1, gen, dev)
    x, y = fcnn_classification_dataset(64, input_dim=NN1[0], seed=3)
    batch = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}
    leaves = fcnn.parameters(params)
    loss_k = fcnn.loss_fn(params, batch)
    g_k = torch.autograd.grad(loss_k, leaves)
    loss_p = fcnn.loss_fn(params, batch, kernel_mode="ref")
    g_p = torch.autograd.grad(loss_p, leaves)
    d_loss = abs(loss_k.item() - loss_p.item())
    print(f"loss kernel {loss_k.item():.7f} plain {loss_p.item():.7f} "
          f"|diff| {d_loss:.3e} (<= {XENT_ATOL:g})")
    check(d_loss <= XENT_ATOL, "fused loss disagrees with the plain loss")
    names = [f"{k}{i + 1}" for i in range(len(NN1) - 1) for k in ("w", "b")]
    for name, a, b in zip(names, g_k, g_p):
        abs_err, rel_err = errors(a, b)
        print(f"grad {name:3s} {tuple(a.shape)!s:12s} max_abs {abs_err:.3e} "
              f"max_rel {rel_err:.3e} (rel<={GEMM_RTOL:g})")
        check(rel_err <= GEMM_RTOL, f"gradient of {name} disagrees")


# ------------------------------------------------------------ phase 5b

PROFILE_STEPS = 50


def run_profile_phase(torch, dev) -> None:
    """Where one NN1 training step's time goes: host ms/step with the
    profiler off, then device busy time per step and the top device
    operations from torch.profiler over as many steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import Batcher, fcnn_classification_dataset
    from repro_torch.launch.train_fcnn import FULL_RUN_STEPS, LR, train_step
    from repro_torch.models import fcnn
    from repro_torch.optim import adam, linear_warmup_cosine

    params = fcnn.init(NN1, torch.Generator().manual_seed(0), dev)
    opt = adam(linear_warmup_cosine(LR, 20, FULL_RUN_STEPS))
    state = opt.init(params)
    x, y = fcnn_classification_dataset(4096, input_dim=NN1[0], seed=0)
    batches = Batcher({"x": x, "y": y}, batch_size=64, device=dev)
    step_t = torch.zeros((), device=dev)

    def steps(n: int) -> None:
        for _ in range(n):
            train_step(params, opt, state, next(batches), step_t)
        torch.cuda.synchronize()

    steps(10)   # warm up
    t0 = time.perf_counter()
    steps(PROFILE_STEPS)
    host_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    print(f"host clock, profiler off: {host_ms:.4f} ms/step over "
          f"{PROFILE_STEPS} steps")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(PROFILE_STEPS)
    rows = device_rows(prof)
    if not rows:
        print("device time: not measured (the profiler recorded no device "
              "events)")
        return
    busy_ms = sum(us for _, _, us in rows) / 1e3 / PROFILE_STEPS
    launches = sum(c for _, c, _ in rows) / PROFILE_STEPS
    print(f"device busy {busy_ms:.5f} ms/step over {launches:.1f} device "
          f"operations/step = {100 * busy_ms / host_ms:.2f}% of the "
          f"profiler-off step (idle {100 - 100 * busy_ms / host_ms:.2f}%)")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:15]:
        print(f"  {us / PROFILE_STEPS:9.3f} us/step {count / PROFILE_STEPS:5.1f}"
              f" calls/step  {key[:100]}")


# ------------------------------------------------------------------ main


def main() -> int:
    import torch

    phase(1, "device")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)

    phase(2, "build")
    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    _build.extension(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}",
          flush=True)

    phase(3, "kernels against their plain versions")
    summary = run_kernel_phase(torch, dev)

    phase(4, "autograd through the fused ops (NN1)")
    run_autograd_phase(torch, dev)

    phase(5, "train NN1 784-1000-500-10, 300 steps, batch 64, seed 0")
    from repro_torch.launch.train_fcnn import train

    ops.reset_launches()
    out = train(arch="NN1", steps=300, batch=64, device=dev, seed=0)
    launches = ops.launch_counts()
    print(f"loss trajectory (every 25 steps): "
          + " ".join(f"{v:.4f}" for v in out["losses"][::25])
          + f" ... {out['losses'][-1]:.4f}")
    print(f"ms/step {out['ms_per_step']:.4f}  final train accuracy "
          f"{out['accuracy']:.4f}")
    print(f"launches in the training run: {launches}")
    per_step = sum(s["ms"] for s in summary.values())
    print(f"kernel time of one step at the NN1 shapes {per_step:.5f} ms "
          f"= {100 * per_step / out['ms_per_step']:.2f}% of ms/step")
    check(out["accuracy"] > 0.8, "NN1 failed to learn (accuracy <= 0.8)")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched by the training run")

    phase("5b", "where the time of an NN1 training step goes")
    run_profile_phase(torch, dev)

    phase(6, "NN5 1024-4000-1000-4000-10, 5 steps, batch 128: kernels vs plain")
    quiet = lambda _: None  # noqa: E731
    k_run = train(arch="NN5", steps=5, batch=128, device=dev, seed=0,
                  log=quiet)
    p_run = train(arch="NN5", steps=5, batch=128, device=dev, seed=0,
                  kernel_mode="ref", log=quiet)
    diff = max(abs(a - b) for a, b in zip(k_run["losses"], p_run["losses"]))
    print("kernel losses " + " ".join(f"{v:.6f}" for v in k_run["losses"]))
    print("plain  losses " + " ".join(f"{v:.6f}" for v in p_run["losses"]))
    print(f"max |diff| {diff:.3e} (<= 1e-4)")
    check(diff <= 1e-4, "NN5 kernel and plain losses disagree")

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"]
            else "operations",
            "library_ms": s["library_ms"],
            "shapes": s["shapes"],
        })
    print("\nper-kernel numbers: device times summed over the calls of one "
          "NN1 training step (the [NN1 step] lines of phase 3)")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
