#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Builds the seven CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's main paths through their own entry points: the
paper's NN1 (784-1000-500-10) trained with Adam, on one device and as a
period program on an 8-device ring, that program again losing two of its
devices and resuming from a checkpoint on the six left, Zamba2-1.2B,
qwen3-14b, qwen2-moe-a2.7b and mamba2-2.7b served at full width in bf16,
and seamless-m4t-large-v2 (full width) and qwen2-vl-72b (full width, cut
in depth) through their prefill and decode steps, and granite-3-2b and
Zamba2-1.2B trained at full width by the LM train step.  Phases, each
printing its own lines; any failure raises and the script exits non-zero
without a result line:

  1. device   a CUDA card is required; its name and power limit; TF32 off
  2. build    the extension, with ptxas's per-kernel resource report
              (registers, shared memory and spills of the redesigned
              kernels, K1, K2, K3 and bf16 K6 and K7, whose spills must be
              0) and the count of HGMMA, HMMA and FFMA instructions in each
              kernel's SASS (cuobjdump); the bf16 K6 and K7 kernels must
              emit HGMMA, and ptxas must not serialize their wgmma
  3. kernels  each FCNN kernel against its plain PyTorch version on the
              card, at the NN1 and NN5 shapes and at edge shapes, with
              times of the kernel, the plain version and one PyTorch
              library call; K1 and K2 (cluster split-K) run twice must
              give bit-identical outputs; each timed K1, K2 and K3 row
              prints what its host plan picked ((split, slice), or K3's dW
              tile height) and the device time of every other choice, each
              held to the plain version; K4/K5 (softmax_xent) in fp32 and
              bf16 at NN1 (64, 10), NN5 (128, 10) and the edges (1, 10)
              and (37, 300), and at LM loss shapes (2048, 49408) fp32 and
              bf16, (4096, 32000), (37, 49408) and (2048, 1000), each K4/K5
              row naming the launch its host plan picked (K4: the
              one-block lane kernel, or the rows kernel's warps a row;
              both: 16-byte vectors or not), nll, lse and the batch mean
              within 1e-5, dlogits element-wise within 1e-5 of its size
              (bf16: one bf16 ulp) plus 1e-6 of its row's largest, K4's
              mean run twice bit-identical; then an empty kernel timed the same way (the
              launch floor) and one NN1 step's forward and backward
              captured in a CUDA graph
  4. autograd gradients of the fused ops on NN1 against autograd of the
              plain versions
  5. train    NN1, 300 steps, batch 64, seed 0, through
              ``repro_torch.launch.train_fcnn.train``; accuracy > 0.8 and
              every FCNN kernel launched (launch counters reset just
              before); then a profiled window of 50 steps: device busy
              time per step and the top device operations
  6. nn5      5 steps of NN5 at batch 128, kernel path against plain path
              from the same seed; losses within 1e-4
  7. lm kernels  flash attention (K6) and the SSD intra-chunk kernel (K7)
              against their plain versions at the Zamba2 prefill shapes
              (bf16 and fp32, causal and not, stride-0 B/C; K7 at 1, 4, 8
              and 16 chunks; bf16 within about one bf16 ulp) and at edge
              shapes; K7 at mamba2-2.7b's (16 chunks, 80 heads, N = 128)
              and at N = 72-128 edges; K6 cross-attention (1, 16, Sq, 64)
              over 1024 keys, Sq = 128, 512, 2048, with Sq != Sk edges
              (Sq = 1, 77 over 203, Sq > Sk); K6 at qwen2-vl-72b's
              (1, 64, 2048, 128) on 8 KV heads; K6 with grouped-query
              attention at qwen3-14b's prefill shapes (1, 40, S, 128) on 8 KV heads, S = 512, 1024,
              2048, and at groups of 1, 4 and 5 with S = 1, 100, 300 and
              D = 64, 128; with kernel, plain, SDPA (``enable_gqa``) and
              bound times (K7's bound
              by bytes and by bf16 operations apart); each K6 line names
              the instantiation that ran (tensor-core bf16 or CUDA-core
              fp32); each timed bf16 K7 row prints the heads per block its
              plan picked and the device time of every other choice, each
              held to the plain version and run twice bit-identical
  8. serve    Zamba2-1.2B, full width, bf16, random weights: 8 requests
              of the ``steady`` preset with 512/1024/2048-token prompts on
              4 slots through ``repro_torch.launch.serve.serve``; every
              request served, K6 and K7 launched 6 and 38 times per
              prefill (counters reset just before); TTFT/TPOT, tok/s and
              peak memory; then a profiled 2048-token prefill, the
              SwiGLU MLP's gate/up GEMMs at that shape with bf16 output
              (the earlier form) and fp32 output (the reference's), and a
              profiled decode step of 4 slots at depth 2048
  9. parity   the full-width model's kernel path against its plain path
              from one set of weights: fp32 prefill logits of a 512-token
              prompt and 8 greedy decode steps within 1e-3 of the largest
              logit; bf16 at 2048 tokens within 4e-2 of the largest
              logit, and the greedy token equal wherever the plain top-2
              gap exceeds twice the logit difference
 10. program  NN1 through its ORRM period program on an 8-device virtual
              ring (``repro_torch.exec``): the program's instruction
              count, degrees and residency peak ratio; K1-K3 at every
              chunk shape of the NN1, NN2 and NN5 programs against their
              plain versions (NN1's timed, and summed over one executor
              step); 300 steps in sharded residency through
              ``repro_torch.launch.train_fcnn.train_program`` to accuracy
              > 0.8 with every off-window slot exactly zero; the kernel
              launches of one executor step (K1 = K3 = 8 + 4 + 2, K2 = 4 +
              2, K4 = K5 = 1), its device busy time and operations; 5 Adam
              steps in sharded and replicated residency bit-identical; and
              the executor's loss and gradients against the single-device
              path for NN1 and NN5 ORRM and NN2 FM/RRM/ORRM
 11. recovery the fault layer (``repro_torch.runtime``) through
              ``repro_torch.launch.elastic_restart``: a crash and restart,
              the replanning oracle at m = 1000/500/100, then NN1 (300
              steps, batch 64, seed 0, phase 10's data and schedule) through
              ``DegradedModeRunner`` on 8 devices, sharded, an async
              checkpoint every 50 steps, under ``seeded_device_loss(0,
              n_lost=2)`` (step 185) and a transient RUN fault failing
              twice at step 10: one replan 8 -> 6 (degrees 2/2/2), resumed
              from the checkpoint of step 149, 2 retries, no kernel
              fallback, the launches per step on each ring equal to its
              program's, accuracy > 0.8; the run matches a from-scratch
              6-device run (losses rtol 1e-4 / atol 1e-6, params rtol 1e-3
              / atol 5e-4), and the replicated run of the same schedule is
              bit-identical; prints the seconds from the fault to the first
              resumed step, the checkpoint's size and save time, and
              ms/step on each ring beside phase 10's; holds K1-K3 at every
              chunk shape of the 6-device program against their plain
              versions; times the recovery over 5 more device losses (a
              40-step run each); then profiles runs of fresh runners on 6
              and on 8 devices with no faults (device operations, host
              ms/step) beside phase 10's executor step
 12. dense    qwen3-14b (GQA 40/8, qk-norm, 40 layers, 14.77 B
              parameters), full width, bf16, random weights drawn layer by
              layer into stacked tensors: 8 requests of the ``steady``
              preset with 512/1024/2048-token prompts on 4 slots through
              ``repro_torch.launch.serve.serve``; every request served, K6
              launched 40 times per prefill (counters reset just before),
              peak memory < 80 GB; TTFT/TPOT, tok/s; then a profiled
              2048-token prefill and a profiled decode step of 4 slots at
              depth 2048
 13. parity   qwen3-14b's kernel path against its plain path: fp32 at full
              width cut to 4 layers, a 512-token prompt and 8 greedy steps
              within 1e-3 of the largest logit; bf16 at full depth, 2048
              tokens, phase 9's logit bar and greedy-token rule
 14. moe      qwen2-moe-a2.7b (60 experts top 4 and 4 shared, QKV bias,
              24 layers), full width, bf16: 4 requests on 4 slots, K6
              launched 24 times per prefill, peak memory < 80 GB; then a
              512-token prefill, kernel path against plain path: the
              expert choices that differ between the paths are counted and
              the greedy-token rule held; with the kernel path's choices
              replayed in the plain path, the logits within phase 9's bar

 15. ssm      mamba2-2.7b (64 attention-free Mamba2 layers, d_model 2560,
              80 heads of 64, state 128, tied embeddings; 2.7 B
              parameters), full width and depth, bf16: 8 requests of
              Zamba2's traffic on 4 slots, K7 launched 64 times and K6 never
              per prefill; a profiled 2048-token prefill and decode step;
              the kernel path against the plain path: fp32 at full depth,
              512 tokens and 8 greedy steps, 1e-3; bf16 at 2048 tokens,
              each layer fed the plain path's input within phase 9's bar,
              the free-running logits within the larger of that bar and
              twice the plain path's own drift with its SSD sum reordered,
              and the greedy-token rule
 16. encdec   seamless-m4t-large-v2 (24 encoder + 24 decoder layers, 16
              heads of 64, d_ff 8192, vocab 256206; 2.0 B parameters), full
              width and depth, bf16, through ``get_model(cfg).prefill`` and
              ``decode_step`` (the serving runner refuses it, as the
              reference's): 1024 random frame embeddings and a 512-token
              prompt, K6 launched 72 times (24 encoder, 24 causal decoder,
              24 cross-attention of 512 queries over 1024 frames), 16
              greedy steps; profiled prefill and decode step; peak memory;
              the kernel path against the plain path: bf16 at 1024/512,
              fp32 at 512/256 with 8 greedy steps
 17. vlm      qwen2-vl-72b (64 heads on 8 KV heads of 128, d_ff 29568,
              M-RoPE 16/24/24), full width cut to 8 of 80 layers (9.5 B
              parameters, 19 GB in bf16): a 32 x 64 image grid's
              embeddings at their M-RoPE positions (2048), K6 launched 8
              times, 8 greedy steps; profiled prefill and decode step; the
              bf16 kernel path against the plain path
 18. train    the LM train step (``repro_torch.launch.steps``):
              granite-3-2b (40 layers, d_model 2048, 32 heads on 8 KV
              heads of 64, d_ff 8192, vocab 49155 padded to 49408, tied;
              2.53 B parameters) at full width and depth, bf16 parameters,
              fp32 AdamW moments, remat, random weights and one batch of
              2 x 2048 seeded token ids in 2 microbatches: 5 steps, every
              loss finite and the last below the first, K4 and K5 launched
              2 times a step and K6/K7 never (counters reset before each
              step), host ms/step, peak memory < 80 GB beside the
              reckoned, a profiled step (device busy, top operations, K4/K5
              and the plain attention's share, the latter timed alone and
              multiplied out); the kernel path against the plain path on
              step 1 from the same weights (loss 1e-5, gradient norm 1e-2
              relative); 3 steps with int8 error feedback, the same checks;
              then Zamba2-1.2B at full width and depth, bf16, batch 1 x
              2048, 3 steps (the loss falls, K4/K5 once a step) and a
              profiled step with the plain SSD's and the shared attention's
              shares of device busy time

The last three lines are a JSON object of per-kernel numbers, the card's
name and power limit as nvidia-smi reports them, and the result object.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Callable, NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data-sheet peaks: HBM bandwidth, fp32 outside the tensor cores,
# dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

GEMM_RTOL = 1e-4    # fp32 sums of up to 4000 terms in another order
XENT_ATOL = 1e-5    # nll, lse and the mean (values of the order of log C)
# dlogits = (p − onehot)·s is held element-wise relative to its size: s is
# g/B (3.4e-4 at the LM's 2048 rows, with p below 1e-4 nearly everywhere),
# so an absolute bar would pass any p.  fp32 within DLOGITS_RTOL of |plain|,
# bf16 within one bf16 ulp (both sides round an fp32 value to bf16), each
# plus DLOGITS_ROW_FLOOR of its row's largest |plain| (p underflows far
# below the row's largest logit)
DLOGITS_RTOL = 1e-5
DLOGITS_ROW_FLOOR = 1e-6

NN1 = [784, 1000, 500, 10]
NN5 = [1024, 4000, 1000, 4000, 10]
ACTS = ("sigmoid", "relu", "tanh", "none")

KERNEL_INFO = {
    # name: (source, TPU kernel it replaces)
    "fcnn_layer": ("src/repro_torch/kernels/csrc/fcnn_fwd.cu",
                   "src/repro/kernels/fcnn_layer.py:142"),
    "fcnn_layer_dgrad": ("src/repro_torch/kernels/csrc/fcnn_dgrad.cu",
                         "src/repro/kernels/fcnn_layer.py:208"),
    "fcnn_layer_wgrad": ("src/repro_torch/kernels/csrc/fcnn_wgrad.cu",
                         "src/repro/kernels/fcnn_layer.py:292"),
    "softmax_xent_fwd": ("src/repro_torch/kernels/csrc/softmax_xent.cu",
                         "src/repro/kernels/softmax_xent.py:111"),
    "softmax_xent_dlogits": ("src/repro_torch/kernels/csrc/softmax_xent.cu",
                             "src/repro/kernels/softmax_xent.py:172"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:72"),
    "ssd_chunk": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                  "src/repro/kernels/ssd_scan.py:60"),
}
FCNN_KERNELS = tuple(KERNEL_INFO)[:5]
XENT_KERNELS = ("softmax_xent_fwd", "softmax_xent_dlogits")
# K4/K5 at LM loss shapes (B·L, padded vocabulary): granite-3-2b's
# microbatch of 2048 tokens (the train path, phase 18), Zamba2's vocabulary
# at 4096 tokens, a ragged batch, a narrow vocabulary, and bf16 logits
LM_XENT_SHAPES = (("2048x49408", 2048, 49408, "float32"),
                  ("4096x32000", 4096, 32000, "float32"),
                  ("37x49408", 37, 49408, "float32"),
                  ("2048x1000", 2048, 1000, "float32"),
                  ("2048x49408", 2048, 49408, "bfloat16"))
LM_XENT_LABEL = "LM 2048x49408 float32"
LM_KERNELS = ("flash_attention", "ssd_chunk")
# the kernels this script holds to 0 spill bytes in ptxas's report, by a
# substring of their mangled names
NO_SPILL_KERNELS = ("fcnn_fwd_kernel", "dgrad_kernel", "fcnn_wgrad_kernel",
                    "flash_fwd_wgmma_kernel", "ssd_chunk_wgmma_kernel")
# the bf16 K6 and K7 kernels, which must run on the tensor cores (HGMMA in
# their SASS) with no wgmma serialized by ptxas
TC_KERNELS = ("flash_fwd_wgmma_kernel", "ssd_chunk_wgmma_kernel")


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


def bound(nbytes: float, flops: float,
          flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """(ms, what bounds it): the larger of bytes over the HBM rate and the
    operations over the peak rate of their type (fp32 by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dlogits_error(out, want) -> float:
    """K5's worst element as a share of its bar (<= 1 passes): |out − want|
    over rtol·|want| + DLOGITS_ROW_FLOOR·(its row's largest |want|), rtol
    DLOGITS_RTOL for fp32 and BF16_ULP for bf16.  Where the bar is 0 (a
    row whose factor is 0) the two must be equal."""
    o, w = out.double(), want.double()
    rtol = BF16_ULP if out.element_size() == 2 else DLOGITS_RTOL
    bar = rtol * w.abs() + DLOGITS_ROW_FLOOR * w.abs().amax(-1, keepdim=True)
    tiny = 2.2250738585072014e-308
    return ((o - w).abs() / bar.clamp_min(tiny)).max().item()


def errors(out, ref) -> tuple[float, float]:
    """(max abs error, max abs error over max |ref|)."""
    abs_err = (out.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return abs_err, abs_err / max(scale, 1e-30)


# --------------------------------------------------------------- phase 2


def build_extension():
    """Build the extension verbosely, copying the compiler's output
    (written to file descriptor 1 by the build's subprocess) to a file in
    the build directory; return (extension, that output)."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = _build.BUILD_DIR / "build_output.txt"
    sys.stdout.flush()
    saved, ext = os.dup(1), None
    try:
        with open(log, "w") as f:
            os.dup2(f.fileno(), 1)
            ext = _build.extension(verbose=True)
            sys.stdout.flush()
    finally:
        os.dup2(saved, 1)
        os.close(saved)
        if ext is None:   # the build failed: show why before raising
            print(log.read_text(), flush=True)
    return ext, log.read_text()


def ptxas_report(text: str) -> dict[str, dict]:
    """{mangled kernel: {registers, smem, spill_stores, spill_loads}} from
    ``-Xptxas=-v`` output."""
    import re

    report, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            report[name] = {"registers": None, "smem": 0, "spill_stores": None,
                            "spill_loads": None}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report[name]["spill_stores"] = int(m.group(1))
            report[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            report[name]["smem"] = int(m.group(1)) if m else 0
    return report


def sass_counts(library: str) -> dict[str, dict[str, int]]:
    """{mangled kernel: {HGMMA, HMMA, FFMA: instruction count}} from
    ``cuobjdump -sass`` of the built extension."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", library], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = {"HGMMA": 0, "HMMA": 0, "FFMA": 0}
        elif name is not None and "/*" in line:
            op = line.split("*/", 1)[-1].strip().split(" ")[0].split(".")[0]
            if op.startswith("@"):   # predicated: the opcode follows
                op = line.split("*/", 1)[-1].strip().split(" ")[1].split(".")[0]
            if op in counts[name]:
                counts[name][op] += 1
    return counts


def run_build_phase() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    ext, text = build_extension()
    print(text, end="")
    print(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}",
          flush=True)
    report = ptxas_report(text)
    if not report:
        print("ptxas report: none (the extension was loaded from an earlier "
              "build in this directory)")
    for name, r in report.items():
        if any(k in name for k in NO_SPILL_KERNELS):
            print(f"ptxas {name[:90]}: {r['registers']} registers, "
                  f"{r['smem']} bytes static smem, spill stores "
                  f"{r['spill_stores']} loads {r['spill_loads']} bytes")
            check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                  f"{name} spills registers")
    counts = sass_counts(ext.__file__)
    print("SASS instructions per kernel (HGMMA HMMA FFMA):")
    for name, c in counts.items():
        print(f"  {c['HGMMA']:5d} {c['HMMA']:5d} {c['FFMA']:6d}  {name[:100]}")
    for kernel in TC_KERNELS:
        found = [c for name, c in counts.items() if kernel in name]
        check(bool(found) and all(c["HGMMA"] > 0 for c in found),
              f"{kernel} has no HGMMA in its SASS")
    serial = [line.strip() for line in text.splitlines()
              if "wgmma.mma_async instructions are serialized" in line]
    for line in serial:
        print(line[:300])
    check(not any(k in line for line in serial for k in TC_KERNELS),
          "ptxas serializes the wgmma of a tensor-core kernel")


# --------------------------------------------------------------- phase 3


class Case(NamedTuple):
    """One comparison of phase 3.  Bytes count each input read once and
    each output written once; flops count the product's multiply-adds as 2
    and each element-wise step as 1.  ``forced(*choice)`` runs a kernel
    with a host plan at one of the CHOICES of its kind: K1 and K2 at a
    (split, slice), K3 at a dW tile (rows, columns); ``plan`` is the
    choice its wrapper makes."""
    name: str
    label: str
    kern: Callable
    plain: Callable
    lib: Callable
    nbytes: int
    flops: int
    timed: bool
    on_path: bool
    plan: tuple | str | None = None
    forced: Callable | None = None


# the plans each kernel with a host plan takes: (split, slice) of the
# cluster split-K kernels, the dW tile (rows, columns) of K3
CHOICES = {
    "fcnn_layer": [(s, sl) for s in (1, 2, 4, 8, 16) for sl in (16, 32)],
    "fcnn_layer_dgrad": [(s, sl) for s in (1, 2, 4, 8) for sl in (16, 32)],
    "fcnn_layer_wgrad": [(64, 64), (128, 64), (128, 128)],
}


def kernel_cases(torch, dev, gen, shapes=None):
    """Yield a Case for every comparison of phase 3, or, given ``shapes``
    (rows of (tag, batch, n_in, n_out, activation, timed)), K1, K2 and K3
    at each of those shapes."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.fcnn_layer import (
        act_code,
        dgrad_plan,
        fcnn_layer,
        fcnn_layer_dgrad,
        fcnn_layer_wgrad,
        fwd_plan,
        wgrad_plan,
    )
    from repro_torch.kernels.softmax_xent import (softmax_xent_dlogits,
                                                  softmax_xent_fwd,
                                                  vector_loads)
    from repro_torch.kernels.softmax_xent import fwd_plan as xent_fwd_plan
    F = torch.nn.functional
    lib_act = {"sigmoid": torch.sigmoid, "relu": torch.relu,
               "tanh": torch.tanh, "none": lambda z: z}

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def layer_cases(tag, sizes, batch, acts_for=None, timed=True,
                    on_path=False):
        l = len(sizes) - 1
        ext = _build.extension()
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

                def fwd_forced(split, slice_, x=x, w=w, b=b, a=act):
                    out = torch.empty(x.shape[0], w.shape[1], device=dev)
                    ext.fcnn_fwd(x, w, b, out, act_code(a), split, slice_)
                    return out

                def dgrad_forced(split, slice_, dy=dy, y=y, w=w, a=act):
                    dx = torch.empty(dy.shape[0], w.shape[0], device=dev)
                    ext.fcnn_dgrad(dy, y, w, dx, act_code(a), split, slice_)
                    return dx

                def wgrad_forced(rows, cols, x=x, dy=dy, y=y, a=act):
                    dw = torch.empty(x.shape[1], dy.shape[1], device=dev)
                    db = torch.empty(dy.shape[1], device=dev)
                    ext.fcnn_wgrad(x, dy, y, dw, db, act_code(a), rows, cols)
                    return dw, db

                # the step skips dgrad of layer 1 (its input needs no grad)
                yield Case("fcnn_layer", lab,
                           lambda x=x, w=w, b=b, a=act: fcnn_layer(x, w, b, a),
                           lambda x=x, w=w, b=b, a=act: ref.fcnn_layer_ref(x, w, b, a),
                           lambda x=x, w=w, b=b, a=act: lib_act[a](torch.addmm(b, x, w)),
                           4 * (m * k + k * n + n + m * n), 2 * m * k * n + 2 * m * n,
                           timed, on_path, fwd_plan(m, k, n), fwd_forced)
                yield Case("fcnn_layer_dgrad", lab,
                           lambda dy=dy, y=y, w=w, a=act: fcnn_layer_dgrad(dy, y, w, a),
                           lambda dy=dy, y=y, w=w, a=act: ref.fcnn_layer_dgrad_ref(dy, y, w, a),
                           lambda dz=dz, w=w: dz @ w.T,
                           4 * (2 * m * n + k * n + m * k), 2 * m * n * k + 2 * m * n,
                           timed, on_path and i > 0, dgrad_plan(m, k, n),
                           dgrad_forced)
                yield Case("fcnn_layer_wgrad", lab,
                           lambda x=x, dy=dy, y=y, a=act: fcnn_layer_wgrad(x, dy, y, a),
                           lambda x=x, dy=dy, y=y, a=act: ref.fcnn_layer_wgrad_ref(x, dy, y, a),
                           lambda x=x, dz=dz: (x.T @ dz, dz.sum(0)),
                           4 * (m * k + 2 * m * n + k * n + n), 2 * m * k * n + 3 * m * n,
                           timed, on_path, wgrad_plan(k, n), wgrad_forced)

    def xent_cases(tag, b, c, dtype=torch.float32, timed=True,
                   on_path=False):
        x = rand(b, c, scale=3.0).to(dtype)
        lab = torch.randint(0, c, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
        lab64 = lab.long()
        onehot = F.one_hot(lab64, c).float()
        _, lse, _ = ref.softmax_xent_fwd_ref(x, lab)
        g = torch.tensor(0.7, device=dev)
        e = x.element_size()
        label = f"{tag} {b}x{c} {str(dtype)[6:]}"
        aligned = x.data_ptr() % 16 == 0
        # K4 writes (nll, lse, mean); K5 takes the loss cotangent g as the
        # training step hands it over; each with the launch its host plan
        # picked
        yield Case("softmax_xent_fwd", label,
                   lambda: softmax_xent_fwd(x, lab),
                   lambda: ref.softmax_xent_fwd_ref(x, lab),
                   lambda: F.cross_entropy(x, lab64, reduction="none"),
                   e * b * c + 4 * 3 * b + 4, 4 * b * c + b, timed, on_path,
                   xent_fwd_plan(b, c, e, aligned))
        yield Case("softmax_xent_dlogits", label,
                   lambda: softmax_xent_dlogits(x, lab, lse, g=g),
                   lambda: ref.softmax_xent_dlogits_ref(x, lab, lse, g=g),
                   lambda: torch.softmax(x.float(), -1) - onehot,
                   2 * e * b * c + 4 * 2 * b + 4, 4 * b * c, timed, on_path,
                   f"vec={vector_loads(c, e, aligned)}")

    if shapes is not None:
        for tag, m, k, n, act, timed in shapes:
            yield from layer_cases(tag, [k, n], m, acts_for=(act,),
                                   timed=timed)
        return
    yield from layer_cases("NN1", NN1, 64, on_path=True)
    yield from xent_cases("NN1", 64, 10, on_path=True)
    yield from xent_cases("NN1", 64, 10, torch.bfloat16)
    yield from layer_cases("NN5", NN5, 128)
    for dtype in (torch.float32, torch.bfloat16):
        yield from xent_cases("NN5", 128, 10, dtype)
    # edges: batch 1, N = 10, K = 784, every activation
    yield from layer_cases("edge", [784, 10], 1, acts_for=ACTS, timed=False)
    yield from layer_cases("edge", NN1[:2], 64, acts_for=ACTS, timed=False)
    for dtype in (torch.float32, torch.bfloat16):
        yield from xent_cases("edge", 1, 10, dtype, timed=False)
        yield from xent_cases("edge", 37, 300, dtype, timed=False)
    for _, b, c, dtype in LM_XENT_SHAPES:
        yield from xent_cases("LM", b, c, getattr(torch, dtype))


def worst_errors(out, want) -> tuple[float, float]:
    """errors() over the outputs of a call (a tensor or a tuple)."""
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    worst_abs = worst_rel = 0.0
    for o, w in zip(outs, wants):
        a, r = errors(o, w)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    return worst_abs, worst_rel


SWEEP_KIND = {"fcnn_layer": "split/slice", "fcnn_layer_dgrad": "split/slice",
              "fcnn_layer_wgrad": "tile"}


def _choice_name(case: Case, choice: tuple[int, ...]) -> str:
    sep = "x" if case.name == "fcnn_layer_wgrad" else "/"
    return sep.join(map(str, choice))


def _agrees(case: Case, out, want) -> tuple[bool, float, str]:
    """(ok, the error the bar is on, the bar): GEMMs relative to the
    largest output, K4 absolute, K5 element-wise (``dlogits_error``, in
    units of its bar)."""
    worst_abs, worst_rel = worst_errors(out, want)
    if case.name.startswith("fcnn"):
        return worst_rel <= GEMM_RTOL, worst_rel, f"rel<={GEMM_RTOL:g}"
    if case.name == "softmax_xent_dlogits":
        err = dlogits_error(out, want)
        rtol = "2^-7" if out.element_size() == 2 else f"{DLOGITS_RTOL:g}"
        return err <= 1, err, (f"|d|<={rtol}|ref|+{DLOGITS_ROW_FLOOR:g}"
                               f"*rowmax at {err:.3f} of it")
    return worst_abs <= XENT_ATOL, worst_abs, f"abs<={XENT_ATOL:g}"


def sweep_line(torch, case: Case, want) -> str:
    """Device ms of a kernel with a host plan at every choice it takes,
    each held to the plain version's output ``want``; the plan's choice and
    the fastest are named."""
    times = {}
    for choice in CHOICES[case.name]:
        out = case.forced(*choice)
        torch.cuda.synchronize()
        ok, err, _ = _agrees(case, out, want)
        check(ok, f"{case.name} {case.label} at {choice}: error {err:.3e}")
        times[choice] = device_ms(lambda c=choice: case.forced(*c))
    best = min(times, key=times.get)
    cells = " ".join(f"{_choice_name(case, c)} {ms:.5f}"
                     for c, ms in times.items())
    return (f"    sweep {SWEEP_KIND[case.name]} device ms: {cells} | plan "
            f"{_choice_name(case, case.plan)} {times[case.plan]:.5f}, fastest "
            f"{_choice_name(case, best)} {times[best]:.5f}")


def run_kernel_phase(torch, dev, shapes=None) -> dict:
    """Phase 3's comparisons (or those of ``kernel_cases``' ``shapes``);
    returns per-kernel sums over the NN1 step's calls and, in "rows", the
    device ms (kernel, plain, library, bound) of every timed case."""
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "library_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
                      "ops_ms": 0.0, "shapes": [], "rows": {}}
               for name in FCNN_KERNELS}
    for case in kernel_cases(torch, dev, gen, shapes):
        name, label = case.name, case.label
        out, want = case.kern(), case.plain()
        torch.cuda.synchronize()
        worst_abs, worst_rel = worst_errors(out, want)
        ok, _, tol = _agrees(case, out, want)
        extra = ""
        if name == "fcnn_layer_wgrad":
            extra = f" tile {case.plan[0]}x{case.plan[1]}"
        elif name.startswith("fcnn"):  # split-K sums in a fixed order
            same = torch.equal(out, case.kern())
            extra = (f" split/slice {case.plan[0]}/{case.plan[1]} repeat "
                     f"{'bit-identical' if same else 'DIFFERS'}")
            ok = ok and same
        elif name == "softmax_xent_fwd":  # the mean in a fixed order
            same = torch.equal(out[2], case.kern()[2])
            extra = (f" mean repeat {'bit-identical' if same else 'DIFFERS'}"
                     f" {case.plan}")
            ok = ok and same
        else:
            extra = f" {case.plan}"
        line = (f"{name:21s} {label:32s} max_abs {worst_abs:.3e} "
                f"max_rel {worst_rel:.3e} ({tol}){extra} "
                f"{'ok' if ok else 'FAIL'}")
        s = summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], worst_abs)
        if case.timed:
            ms, plain_ms, lib_ms = (device_ms(case.kern), device_ms(case.plain),
                                    device_ms(case.lib))
            b_ms, b_by = bound(case.nbytes, case.flops)
            s["rows"][label] = (ms, plain_ms, lib_ms, b_ms)
            line += (f" | device ms: kernel {ms:.5f} plain {plain_ms:.5f} "
                     f"library {lib_ms:.5f} bound {b_ms:.7f} ({b_by}) | "
                     f"eager ms: kernel {eager_ms(case.kern):.5f} plain "
                     f"{eager_ms(case.plain):.5f}"
                     f"{' [NN1 step]' if case.on_path else ''}")
            if case.on_path:
                s["ms"] += ms
                s["plain_ms"] += plain_ms
                s["library_ms"] += lib_ms
                s["bound_ms"] += b_ms
                s["bytes_ms"] += case.nbytes / HBM_BYTES_PER_S * 1e3
                s["ops_ms"] += case.flops / FP32_FLOP_PER_S * 1e3
                s["shapes"].append(label)
        print(line, flush=True)
        check(ok, f"{name} {label} disagrees with its plain version")
        if case.timed and case.forced is not None:
            print(sweep_line(torch, case, want), flush=True)
    for name in FCNN_KERNELS if shapes is None else ():
        s = summary[name]
        print(f"NN1 step, {name}: kernel {s['ms']:.5f} ms, library "
              f"{s['library_ms']:.5f} ms, plain {s['plain_ms']:.5f} ms, bound "
              f"{s['bound_ms']:.7f} ms over {len(s['shapes'])} calls")
    return summary


def nn1_step_parts(torch, dev):
    """(params, leaves, batch, Adam, its state, step counter) of an NN1
    training step at batch 64."""
    from repro_torch.data import fcnn_classification_dataset
    from repro_torch.launch.train_fcnn import FULL_RUN_STEPS, LR
    from repro_torch.models import fcnn
    from repro_torch.optim import adam, linear_warmup_cosine

    params = fcnn.init(NN1, torch.Generator().manual_seed(0), dev)
    x, y = fcnn_classification_dataset(64, input_dim=NN1[0], seed=0)
    batch = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}
    opt = adam(linear_warmup_cosine(LR, 20, FULL_RUN_STEPS))
    return (params, fcnn.parameters(params), batch, opt, opt.init(params),
            torch.zeros((), device=dev))


def run_floor_and_chain(torch, dev, summary) -> None:
    """K4 and K5 beside an empty kernel timed the same way (the launch
    floor), and one NN1 step's forward and backward (loss_fn, then
    autograd.grad: K1 x3, K4, K5, K3 x3, K2 x2 and autograd's own
    operations) captured in a CUDA graph."""
    from repro_torch.kernels import _build
    from repro_torch.launch.train_fcnn import train_step
    from repro_torch.models import fcnn

    ext = _build.extension()
    floor = device_ms(ext.launch_floor)
    print(f"launch floor, an empty kernel in the same harness (CUDA-graph "
          f"replay): {floor:.5f} ms")
    for name in ("softmax_xent_fwd", "softmax_xent_dlogits"):
        ms = summary[name]["ms"]
        print(f"  {name} at NN1 (64x10 fp32): {ms:.5f} ms = "
              f"{ms / floor:.2f}x the floor")
    params, leaves, batch, opt, state, step_t = nn1_step_parts(torch, dev)

    def fwd_bwd():
        return torch.autograd.grad(fcnn.loss_fn(params, batch), leaves)

    def step():
        train_step(params, opt, state, batch, step_t)

    print(f"NN1 step chain, forward+backward in a CUDA graph: "
          f"{device_ms(fwd_bwd, iters=10, replays=30):.5f} ms device")
    print(f"NN1 step as the port runs it: forward+backward eager "
          f"{eager_ms(fwd_bwd, iters=100):.5f} ms, whole Adam step "
          f"{eager_ms(step, iters=100):.5f} ms (CUDA events, host included)")


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
    """Where one NN1 training step's time goes (``profile_steps``)."""
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
    profile_steps(torch, lambda: train_step(params, opt, state, next(batches),
                                            step_t))


def profile_steps(torch, step: Callable[[], object]) -> tuple[float, float]:
    """profile_runs of ``step`` called over and over."""
    def steps(n: int) -> None:
        for _ in range(n):
            step()
        torch.cuda.synchronize()

    return profile_runs(torch, steps)


def profile_runs(torch, steps: Callable[[int], None]) -> tuple[float, float]:
    """Host ms/step of ``steps(n)`` (which runs n steps and waits for the
    device) with the profiler off, then device busy time per step and the
    top device operations from torch.profiler over as many steps; returns
    (host ms/step, device operations/step)."""
    from torch.profiler import ProfilerActivity, profile

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
        return host_ms, 0.0
    busy_ms = sum(us for _, _, us in rows) / 1e3 / PROFILE_STEPS
    launches = sum(c for _, c, _ in rows) / PROFILE_STEPS
    print(f"device busy {busy_ms:.5f} ms/step over {launches:.1f} device "
          f"operations/step = {100 * busy_ms / host_ms:.2f}% of the "
          f"profiler-off step (idle {100 - 100 * busy_ms / host_ms:.2f}%)")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:15]:
        print(f"  {us / PROFILE_STEPS:9.3f} us/step {count / PROFILE_STEPS:5.1f}"
              f" calls/step  {key[:100]}")
    return host_ms, launches


# --------------------------------------------------------------- phase 7

K6_FP32_RTOL = 2e-5    # of the largest output: fp32 sums in another order
K7_FP32_RTOL = 1e-5
# A bf16 output is held element-wise to BF16_ULP·|plain| (both sides round
# their fp32 result to bf16: one ulp apart at most) plus a slack, and as a
# whole to ||out − plain||_2 <= BF16_ULP·||plain||_2.  K6's slack is
# BF16_ULP·(softmax @ |v|): the kernel rounds exp(s − running max) to bf16
# before PV, as the TPU kernel does, where the plain version rounds the
# normalised softmax, so each probability may differ by one rounding of
# each.  K7's slack is 1e-3 of the largest output (fp32 sums in another
# order).
BF16_ULP = 2.0 ** -7
K7_BF16_SLACK = 1e-3
K7_BF16_STATE_RTOL = 1e-3  # fp32 state and decay from bf16 inputs
# bf16 full-width prefill logits, kernel path against plain path, as a
# share of the largest logit: 2.0% measured at 2048 tokens (38 layers of
# bf16 rounding of differently ordered sums, random weights)
BF16_LOGIT_RTOL = 4e-2
ARCH = "zamba2-1.2b"
DENSE_ARCH = "qwen3-14b"
MOE_ARCH = "qwen2-moe-a2.7b"
SSM_ARCH = "mamba2-2.7b"
ENCDEC_ARCH = "seamless-m4t-large-v2"
VLM_ARCH = "qwen2-vl-72b"
SERVE_BUCKETS = (512, 1024, 2048)
# the K6 shape of each path's prefill: (B, H, KV, Sq, D, Sk, causal); the
# encoder-decoder's is its cross-attention (512 decoder tokens over 1024
# encoder frames, phase 16)
K6_PATHS = {ARCH: (1, 32, 32, 2048, 64, 2048, True),
            DENSE_ARCH: (1, 40, 8, 2048, 128, 2048, True),
            MOE_ARCH: (1, 16, 16, 2048, 128, 2048, True),
            ENCDEC_ARCH: (1, 16, 16, 512, 64, 1024, False),
            VLM_ARCH: (1, 64, 8, 2048, 128, 2048, True)}
# the K7 shape of each path's 2048-token prefill: (BC, Q, H, P, N), one
# B/C group broadcast to the heads (stride 0)
K7_PATHS = {ARCH: (16, 128, 64, 64, 64), SSM_ARCH: (16, 128, 80, 64, 128)}


def _close(torch, out, want, fp32_rtol, slack) -> tuple[bool, float, str]:
    """(ok, max abs error, criterion and margins) for one output against
    its plain version: relative to the largest value in fp32; for a bf16
    output, element-wise BF16_ULP·|ref| + ``slack()`` (K7_BF16_SLACK of the
    largest value where ``slack`` is None) and norm-wise BF16_ULP."""
    a, r = errors(out, want)
    if out.dtype != torch.bfloat16:
        return r <= fp32_rtol, a, f"rel<={fp32_rtol:g}"
    o, w = out.double(), want.double()
    extra = (K7_BF16_SLACK * w.abs().max() if slack is None
             else slack().double())
    worst = ((o - w).abs() / (BF16_ULP * w.abs() + extra)).max().item()
    norm = ((o - w).norm() / w.norm()).item()
    name = "2^-7(|ref|+P|v|)" if slack is not None else "2^-7|ref|+1e-3max"
    ok = worst <= 1 and norm <= BF16_ULP
    return ok, a, (f"|d|<={name} at {worst:.3f} of it, ||d||/||ref|| "
                   f"{norm:.2e}<=2^-7")


class LMCase(NamedTuple):
    """One comparison of phase 7.  Bytes count each input read once (a
    stride-0 B/C once per chunk, K and V once per KV head) and each output
    written once; flops count what these inputs need (causal pairs only, 2
    per multiply-add), at the peak of the inputs' type (``rate``).
    ``slack()`` is K6's bf16 slack, BF16_ULP·(softmax @ |v|) (None: K7's);
    ``forced(heads)`` runs bf16 K7 at one of ssd_scan.SSD_HEADS heads per
    block, ``plan`` being its wrapper's; ``on_path`` names the serving path
    whose prefill runs this shape ("" for none)."""
    name: str
    label: str
    kern: Callable
    plain: Callable
    slack: Callable | None
    lib: Callable | None
    nbytes: int
    flops: int
    rate: float
    timed: bool
    on_path: str
    plan: int | None = None
    forced: Callable | None = None


def lm_kernel_cases(torch, dev, gen):
    """Yield an LMCase for every comparison of phase 7."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_plan
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def flash_case(b, h, s, d, dtype, causal, timed, kv=None, sk=None):
        # the model's layout: (B, S, H, D) projections seen as (B, H, S, D);
        # k and v with kv heads (GQA, h // kv query heads a group) and sk
        # rows (cross-attention where sk != s)
        kv, sk = kv or h, sk or s
        q = rand(b, s, h, d, dtype=dtype).transpose(1, 2)
        k, v = (rand(b, sk, kv, d, dtype=dtype).transpose(1, 2)
                for _ in range(2))
        e = q.element_size()
        pairs = s * (s + 1) // 2 if causal else s * sk
        rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
        label = (f"({b},{h},{s},{d}){f' kv {kv}' if kv != h else ''}"
                 f"{f' over Sk {sk}' if sk != s else ''} "
                 f"{str(dtype)[6:]} {'causal' if causal else 'full'}")
        path = [a for a, shape in K6_PATHS.items()
                if (b, h, kv, s, d, sk, causal) == shape
                and dtype == torch.bfloat16]
        yield LMCase(
            "flash_attention", label,
            lambda: flash_attention(q, k, v, causal),
            lambda: ref.flash_attention_ref(q, k, v, causal),
            lambda: BF16_ULP * ref.flash_attention_ref(
                q.float(), k.float(), v.float().abs(), causal),
            lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=kv != h),
            2 * b * (h * s + kv * sk) * d * e, 4 * b * h * pairs * d, rate,
            timed, path[0] if path else "")

    def ssd_case(bc, q, h, p, n, dtype, shared_bc, timed):
        x = rand(bc, q, h, p, dtype=dtype)
        dt_a = -rand(bc, q, h).abs() * 0.3
        g = 1 if shared_bc else h
        b = rand(bc, q, g, n, dtype=dtype).expand(bc, q, h, n)
        c = rand(bc, q, g, n, dtype=dtype).expand(bc, q, h, n)
        e = x.element_size()
        pairs = q * (q + 1) // 2
        flops = bc * h * (pairs * (2 * n + 2 * p) + 2 * q * p * n)
        nbytes = (2 * bc * q * h * p * e + 2 * bc * q * g * n * e
                  + bc * h * p * n * 4 + 2 * bc * q * h * 4)
        bf16 = dtype == torch.bfloat16
        label = (f"BC={bc} ({q},{h},{p},{n}) {str(dtype)[6:]}"
                 f"{' stride-0 b/c' if shared_bc else ''}")

        def forced(heads):
            y = torch.empty_like(x)
            state = torch.empty((bc, h, p, n), device=dev)
            decay = torch.empty((bc, q, h), device=dev)
            _build.extension().ssd_chunk(x, dt_a, b, c, y, state, decay, heads)
            return y, state, decay

        path = [a for a, shape in K7_PATHS.items()
                if (bc, q, h, p, n) == shape and bf16 and shared_bc]
        yield LMCase(
            "ssd_chunk", label,
            lambda: ssd_chunk(x, dt_a, b, c),
            lambda: ref.ssd_chunk_ref(x, dt_a, b, c),
            None, None, nbytes, flops,
            BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S, timed,
            path[0] if path else "",
            ssd_plan(bc, h, q, shared_bc, n) if bf16 else None,
            forced if bf16 and timed else None)

    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            for s in (128, 512, 1024, 2048):
                yield from flash_case(1, 32, s, 64, dtype, causal, True)
            for shape in ((1, 32, 8, 64), (1, 32, 100, 64), (2, 4, 300, 128),
                          (1, 2, 128, 32), (2, 4, 256, 64), (1, 1, 64, 128)):
                yield from flash_case(*shape, dtype, causal, False)
        # GQA: qwen3-14b's prefill (40 query heads on 8 KV heads, D 128),
        # then groups of 1, 4 and 5 at the edges of S and D
        for s in (512, 1024, 2048):
            yield from flash_case(1, 40, s, 128, dtype, True, True, kv=8)
        # qwen2-moe-a2.7b's prefill: 16 heads, D 128, no GQA
        for s in (512, 1024, 2048):
            yield from flash_case(1, 16, s, 128, dtype, True, True)
        for causal in (True, False):
            for b, h, kv, s, d in ((1, 8, 8, 100, 128), (2, 8, 2, 300, 64),
                                   (1, 10, 2, 1, 128), (1, 10, 2, 300, 128),
                                   (2, 4, 1, 100, 64), (1, 5, 1, 1, 64),
                                   (1, 20, 4, 300, 64), (1, 40, 8, 100, 128)):
                yield from flash_case(b, h, s, d, dtype, causal, False, kv)
        # cross-attention (seamless-m4t-large-v2: 16 heads of 64 over 1024
        # encoder frames, not causal), then Sq != Sk at the edges: one
        # query, ragged lengths, more queries than keys, GQA, D = 128
        for s in (128, 512, 2048):
            yield from flash_case(1, 16, s, 64, dtype, False, True, sk=1024)
        for b, h, kv, s, d, sk in ((1, 16, 16, 1, 64, 1024),
                                   (1, 4, 4, 77, 64, 203),
                                   (2, 4, 4, 300, 64, 100),
                                   (1, 8, 2, 77, 128, 203),
                                   (2, 6, 3, 129, 32, 1),
                                   (1, 4, 4, 1, 128, 1)):
            yield from flash_case(b, h, s, d, dtype, False, False, kv, sk)
        # qwen2-vl-72b's prefill: 64 query heads on 8 KV heads of 128 (G = 8)
        yield from flash_case(1, 64, 2048, 128, dtype, True, True, kv=8)
        # one 128-token chunk, then the 512/1024/2048-token prompt buckets
        for bc in (1, 4, 8, 16):
            yield from ssd_case(bc, 128, 64, 64, 64, dtype, True, True)
        # mamba2-2.7b's 512/1024/2048-token prefills: 80 heads, N = 128
        for bc in (4, 8, 16):
            yield from ssd_case(bc, 128, 80, 64, 128, dtype, True, True)
        for shape in ((2, 16, 8, 8, 4), (1, 32, 4, 16, 8), (3, 8, 16, 8, 16)):
            yield from ssd_case(*shape, dtype, False, False)
            yield from ssd_case(*shape, dtype, True, False)
        # N > 64 at the edges: ragged chunk, N = 96, per-head B/C, P < 64
        for shape in ((2, 100, 8, 64, 128), (3, 128, 4, 64, 96),
                      (2, 77, 6, 32, 128), (1, 128, 3, 64, 72),
                      (1, 64, 2, 30, 90)):
            yield from ssd_case(*shape, dtype, False, False)
            yield from ssd_case(*shape, dtype, True, False)


def lm_compare(torch, case: LMCase, outs, wants) -> tuple[bool, float, str]:
    """(ok, max abs error, criterion) of a call's outputs against its plain
    version's: _close() for y and o; K7's fp32 state and decay from bf16
    inputs within K7_BF16_STATE_RTOL of their largest value."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    wants = wants if isinstance(wants, tuple) else (wants,)
    ok, worst, crit = True, 0.0, ""
    fp32_rtol = K6_FP32_RTOL if case.name == "flash_attention" else K7_FP32_RTOL
    for i, (o, w) in enumerate(zip(outs, wants)):
        if i > 0 and o.dtype == torch.float32 and outs[0].dtype == torch.bfloat16:
            a, r = errors(o, w)
            good, c = r <= K7_BF16_STATE_RTOL, f"rel<={K7_BF16_STATE_RTOL:g}"
        else:
            good, a, c = _close(torch, o, w, fp32_rtol, case.slack)
        ok, worst = ok and good, max(worst, a)
        crit = crit or c
    return ok, worst, crit


def k7_sweep_line(torch, case: LMCase, wants) -> str:
    """Device ms of bf16 K7 at every heads-per-block choice, each held to
    the plain version's outputs ``wants`` and run twice bit-identical; the
    plan's choice and the fastest are named."""
    from repro_torch.kernels.ssd_scan import SSD_HEADS

    times = {}
    for heads in sorted(SSD_HEADS):
        out = case.forced(heads)
        torch.cuda.synchronize()
        ok, _, crit = lm_compare(torch, case, out, wants)
        same = all(torch.equal(a, b) for a, b in zip(out, case.forced(heads)))
        check(ok and same, f"ssd_chunk {case.label} at {heads} heads a block: "
                           f"{crit}{'' if same else ', repeats differ'}")
        times[heads] = device_ms(lambda h=heads: case.forced(h), iters=5)
    best = min(times, key=times.get)
    cells = " ".join(f"{h} {ms:.5f}" for h, ms in times.items())
    return (f"    sweep heads/block device ms: {cells} | plan {case.plan} "
            f"{times[case.plan]:.5f}, fastest {best} {times[best]:.5f}; every "
            f"choice within the bars, repeats bit-identical")


def run_lm_kernel_phase(torch, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(7)
    summary = {name: {"max_abs_err": 0.0, "ms": None, "plain_ms": None,
                      "library_ms": None, "bound_ms": None, "bound_by": None,
                      "shapes": [], "paths": {}}
               for name in LM_KERNELS}
    for case in lm_kernel_cases(torch, dev, gen):
        name, label = case.name, case.label
        outs, wants = case.kern(), case.plain()
        torch.cuda.synchronize()
        ok, worst, crit = lm_compare(torch, case, outs, wants)
        if name == "flash_attention":
            label += (" [tensor-core bf16]" if outs.dtype == torch.bfloat16
                      else " [CUDA-core fp32]")
        line = (f"{name:15s} {label:58s} max_abs {worst:.3e} ({crit}) "
                f"{'ok' if ok else 'FAIL'}")
        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], worst)
        if case.timed:
            kern, plain, lib = case.kern, case.plain, case.lib
            ms, plain_ms = device_ms(kern, iters=5), device_ms(plain, iters=5)
            lib_ms = device_ms(lib, iters=5) if lib is not None else None
            b_ms, b_by = bound(case.nbytes, case.flops, case.rate)
            line += (f" | device ms: kernel {ms:.5f} plain {plain_ms:.5f} "
                     f"library {'none' if lib_ms is None else f'{lib_ms:.5f}'}"
                     f" bound {b_ms:.5f} ({b_by}) = {100 * b_ms / ms:.1f}% | "
                     f"{case.flops / ms / 1e9:.2f} TFLOP/s, "
                     f"{case.nbytes / ms / 1e6:.1f} GB/s"
                     f"{f' [{case.on_path} serving path]' if case.on_path else ''}")
            if case.forced is not None:
                line += (f" | bound by bytes "
                         f"{case.nbytes / HBM_BYTES_PER_S * 1e3:.5f}, by bf16 "
                         f"ops {case.flops / case.rate * 1e3:.5f} | plan "
                         f"{case.plan} heads/block")
            if case.on_path:
                row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by, shapes=[label])
                summary[name]["paths"][case.on_path] = row
                if case.on_path == ARCH:
                    summary[name].update(row)
        print(line, flush=True)
        check(ok, f"{name} {label} disagrees with its plain version")
        if case.forced is not None:
            print(k7_sweep_line(torch, case, wants), flush=True)
    return summary


# --------------------------------------------------------------- phase 8


def launches_per_prefill(cfg) -> dict[str, int]:
    """K6 and K7 launches of one prefill: the hybrid's shared-attention
    invocations and Mamba layers; one K7 per layer of the Mamba2 LM; one K6
    per encoder layer and two per decoder layer (self- and
    cross-attention) of the encoder-decoder; one K6 per layer of a dense,
    MoE or VLM stack."""
    from repro_torch.models.zamba2 import n_shared_invocations

    if cfg.family == "hybrid":
        return {"flash_attention": n_shared_invocations(cfg),
                "ssd_chunk": cfg.n_layers}
    if cfg.family == "ssm":
        return {"flash_attention": 0, "ssd_chunk": cfg.n_layers}
    if cfg.family == "encdec":
        return {"flash_attention": cfg.n_encoder_layers + 2 * cfg.n_layers,
                "ssd_chunk": 0}
    return {"flash_attention": cfg.n_layers, "ssd_chunk": 0}


def free_device_memory(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def run_serve_phase(torch, dev, arch: str = ARCH,
                    n_requests: int = 8) -> dict[str, int]:
    """Serve ``arch`` at full width through the port's entry point; return
    the LM kernels' launch counts of that run (counters reset just
    before)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import report_lines, serve
    from repro_torch.serve import WallClock

    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    result = serve(arch, scenario="steady", n_requests=n_requests,
                   prompt_buckets=SERVE_BUCKETS, slots=4, seed=0, device=dev,
                   clock=WallClock())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    cfg, sc = result.cfg, result.scenario
    for line in report_lines(result, 0, 4, 1):
        print(line)
    n_prefill = result.n_prefills + len(sc.prompt_buckets)   # + warmup
    per = launches_per_prefill(cfg)
    print(f"prompt buckets {SERVE_BUCKETS}: "
          f"{result.n_prefills} prefills + {len(sc.prompt_buckets)} warmup, "
          f"{result.n_decode_steps} decode steps; wall {wall:.2f} s "
          f"(warmup and weights included)")
    print(f"launches in the serving run: {launches}")
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory {peak / 2**30:.3f} GiB = {peak / 1e9:.3f} GB "
          f"(torch.cuda.max_memory_allocated; < 80 GB)")
    check(peak < 80e9, f"peak device memory {peak / 1e9:.3f} GB >= 80 GB")
    check(result.slo.n_finished == sc.n_requests,
          f"served {result.slo.n_finished}/{sc.n_requests} requests")
    for name in LM_KERNELS:
        check(launches[name] == per[name] * n_prefill,
              f"{name} launched {launches[name]} times, expected "
              f"{per[name]} per prefill x {n_prefill}")
        if per[name]:
            check(launches[name] > 0, f"{name} never launched")
    return {name: launches[name] for name in LM_KERNELS}


def run_prefill_profile(torch, dev, model, params, tokens, batch=None,
                        max_len=None, what=None) -> None:
    """Where a 2048-token prefill's time goes: host ms with the profiler
    off, then device time of K6, K7 and everything from torch.profiler.
    ``batch``, ``max_len`` and ``what`` replace the token prompt's batch,
    cache depth and name (the encoder-decoder's and VLM's inputs)."""
    from torch.profiler import ProfilerActivity, profile

    batch = batch or {"tokens": tokens}
    max_len = max_len or tokens.shape[1] + 16
    what = what or f"{tokens.shape[1]}-token prefill"
    reps = 3
    with torch.inference_mode():
        model.prefill(params, batch, max_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            model.prefill(params, batch, max_len)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.prefill(params, batch, max_len)
            torch.cuda.synchronize()
    print(f"{what}, profiler off: {host_ms:.3f} ms (mean of {reps})")
    rows = device_rows(prof)
    if not rows:
        print("device time: not measured (the profiler recorded no device "
              "events)")
        return
    busy = sum(us for _, _, us in rows) / 1e3
    k6 = sum(us for k, _, us in rows if "flash_fwd" in k) / 1e3
    k7 = sum(us for k, _, us in rows if "ssd_chunk" in k) / 1e3
    print(f"device busy {busy:.3f} ms = {100 * busy / host_ms:.1f}% of the "
          f"profiler-off prefill; K6 flash_attention {k6:.3f} ms "
          f"({100 * k6 / busy:.1f}% of busy), K7 ssd_chunk {k7:.3f} ms "
          f"({100 * k7 / busy:.1f}%)")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"  {us / 1e3:9.4f} ms {count:4d} calls  {key[:100]}")


def run_mlp_timing(torch, dev, cfg, params, tokens: int) -> None:
    """The SwiGLU MLP's cost at the prefill shape, before and after it kept
    its gate and up products in fp32: each (tokens, d_model) x (d_model,
    d_ff) GEMM with bf16 output (the earlier form) and with fp32 output
    (``layers.matmul_fp32``), and the whole MLP in both forms; a prefill
    runs the MLP once per shared-block invocation."""
    from repro_torch.models import layers as L
    from repro_torch.models.zamba2 import n_shared_invocations

    p = params["shared"]["mlp"]
    x = torch.randn((1, tokens, cfg.d_model), device=dev).to(torch.bfloat16)
    silu = torch.nn.functional.silu

    def mlp_bf16_products():
        g = torch.matmul(x, p["w_gate"])
        u = torch.matmul(x, p["w_up"])
        h = (silu(g.float()) * u.float()).to(x.dtype)
        return torch.matmul(h, p["w_down"])

    with torch.inference_mode():
        got = L.matmul_fp32(x, p["w_gate"])
        want = torch.matmul(x.float(), p["w_gate"].float())
        check(got.dtype == torch.float32, "matmul_fp32 does not return fp32")
        rel = errors(got, want)[1]
        check(rel <= 1e-5, f"bf16 GEMM with fp32 output is {rel:.3e} from "
                           f"the fp32 product of the upcast operands")
        gemm = {name: device_ms(fn, iters=3) for name, fn in (
            ("bf16 out", lambda: torch.matmul(x, p["w_gate"])),
            ("fp32 out", lambda: L.matmul_fp32(x, p["w_gate"])))}
        whole = {name: device_ms(fn, iters=3) for name, fn in (
            ("bf16 products", mlp_bf16_products),
            ("fp32 products", lambda: L.mlp(p, x)))}
    calls = n_shared_invocations(cfg)
    flops = 2 * tokens * cfg.d_model * cfg.d_ff
    print(f"MLP gate/up GEMM ({tokens}x{cfg.d_model})x({cfg.d_model}x"
          f"{cfg.d_ff}) bf16 operands: bf16 output {gemm['bf16 out']:.4f} ms, "
          f"fp32 output {gemm['fp32 out']:.4f} ms "
          f"({flops / gemm['fp32 out'] / 1e9:.1f} TFLOP/s; {rel:.1e} from "
          f"the fp32 product); x{2 * calls} a prefill: "
          f"{2 * calls * gemm['bf16 out']:.3f} -> "
          f"{2 * calls * gemm['fp32 out']:.3f} ms")
    print(f"MLP whole: g, u rounded to bf16 {whole['bf16 products']:.4f} ms, "
          f"kept fp32 {whole['fp32 products']:.4f} ms; x{calls} a prefill: "
          f"{calls * whole['bf16 products']:.3f} -> "
          f"{calls * whole['fp32 products']:.3f} ms")


def run_decode_profile(torch, dev, model, params, cache=None) -> None:
    """Where a batched decode step's time goes: 4 slots each 2048 tokens
    deep in a cache sized as the serving run's, or the rows of ``cache``
    (a prefill's) at their depth."""
    from torch.profiler import ProfilerActivity, profile

    slots, depth, steps = 4, max(SERVE_BUCKETS), 10
    if cache is None:
        cache = model.init_cache(slots, depth + 16, dev)
        cache["len"].fill_(depth)
    slots, depth = cache["len"].shape[0], int(cache["len"][0])
    batch = {"tokens": torch.zeros((slots, 1), dtype=torch.int64, device=dev)}
    with torch.inference_mode():
        for _ in range(3):
            model.decode_step(params, cache, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode_step(params, cache, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                model.decode_step(params, cache, batch)
            torch.cuda.synchronize()
    print(f"decode step, {slots} slots at depth {depth}, profiler off: "
          f"{host_ms:.3f} ms (mean of {steps})")
    rows = device_rows(prof)
    if not rows:
        print("device time: not measured (the profiler recorded no device "
              "events)")
        return
    busy = sum(us for _, _, us in rows) / 1e3 / steps
    n_ops = sum(c for _, c, _ in rows) / steps
    print(f"device busy {busy:.3f} ms/step over {n_ops:.0f} device "
          f"operations/step = {100 * busy / host_ms:.1f}% of the step "
          f"(idle {100 - 100 * busy / host_ms:.1f}%)")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:8]:
        print(f"  {us / 1e3 / steps:9.4f} ms/step {count / steps:6.1f} "
              f"calls/step  {key[:90]}")


# --------------------------------------------------------------- phase 9


def run_parity_phase(torch, dev, model_bf16, params_bf16, tokens_2048,
                     arch: str = ARCH, fp32_layers: int | None = None) -> None:
    """``arch``'s kernel path against its plain path: fp32 at full width
    (cut to ``fp32_layers`` layers where given), then bf16 at full depth
    from ``params_bf16``."""
    run_fp32_parity(torch, dev, tokens_2048, arch, fp32_layers)
    # bf16, full width, 2048-token prompt
    with torch.inference_mode():
        batch = {"tokens": tokens_2048}
        lk, _ = model_bf16.prefill(params_bf16, batch, 2064)
        lp, _ = model_bf16.prefill(params_bf16, batch, 2064, mode="ref")
    bf16_logit_check(torch, lk, lp, f"bf16 {tokens_2048.shape[1]}-token "
                                    f"prefill")


def run_fp32_parity(torch, dev, tokens_2048, arch: str,
                    fp32_layers: int | None = None) -> None:
    """``arch`` in fp32 at full width (cut to ``fp32_layers`` layers where
    given): a 512-token prefill and 8 greedy steps, kernel path against
    plain path within 1e-3 of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    # fp32, full width, 512-token prompt, then 8 greedy steps
    cfg32 = get_config(arch).replace(dtype="float32", param_dtype="float32")
    if fp32_layers is not None:
        cfg32 = cfg32.replace(n_layers=fp32_layers)
        print(f"fp32 at full width, cut to {fp32_layers} of "
              f"{get_config(arch).n_layers} layers (weights in fp32 would "
              f"not fit beside the bf16 model)")
    m32 = get_model(cfg32)
    with torch.inference_mode():
        p32 = m32.init(torch.Generator(device=dev).manual_seed(1), dev)
        toks = tokens_2048[:, :512]
        lk, ck = m32.prefill(p32, {"tokens": toks}, 528)
        lp, cp = m32.prefill(p32, {"tokens": toks}, 528, mode="ref")
        worst = 0.0
        for step in range(9):
            scale = lp.abs().max().item()
            diff = (lk - lp).abs().max().item()
            worst = max(worst, diff / scale)
            print(f"fp32 {'prefill' if step == 0 else f'decode {step}'}: "
                  f"max |dlogit| {diff:.3e} of max |logit| {scale:.3f} "
                  f"= {diff / scale:.3e} (<= 1e-3)")
            check(diff <= 1e-3 * scale,
                  "fp32 kernel-path logits disagree with the plain path")
            if step == 8:
                break
            tok = torch.argmax(lp[:, -1], dim=-1)[:, None]
            lk, ck = m32.decode_step(p32, ck, {"tokens": tok})
            lp, cp = m32.decode_step(p32, cp, {"tokens": tok})
        for key in sorted(set(ck) - {"len"}):
            a, r = errors(ck[key], cp[key])
            print(f"fp32 cache {key}: max_abs {a:.3e} max_rel {r:.3e}")
    del p32, ck, cp
    free_device_memory(torch)


def bf16_logit_check(torch, lk, lp, what: str) -> None:
    """bf16 kernel-path logits ``lk`` against plain-path ``lp``: within
    BF16_LOGIT_RTOL of the largest logit, and the greedy token equal where
    the plain top-2 gap exceeds twice the logit difference."""
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    top2 = torch.topk(lp[0, -1], 2).values
    gap = (top2[0] - top2[1]).item()
    tk, tp = int(torch.argmax(lk[0, -1])), int(torch.argmax(lp[0, -1]))
    print(f"{what}: max |dlogit| {diff:.4e} of max |logit| "
          f"{scale:.3f} = {diff / scale:.3e} (<= {BF16_LOGIT_RTOL:g}); plain "
          f"top-2 gap {gap:.4e}; greedy token kernel {tk} plain {tp}")
    check(diff <= BF16_LOGIT_RTOL * scale,
          "bf16 kernel-path logits disagree with the plain path")
    if gap > 2 * diff:
        check(tk == tp, "bf16 greedy token differs where the top-2 gap "
                        "exceeds twice the logit difference")
    else:
        print("top-2 gap within twice the logit difference: token equality "
              "not required")


def lm_path_phases(torch, dev) -> tuple[dict, dict]:
    """Phases 7-9; returns (phase-7 summary, phase-8 launch counts)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    phase(7, "flash attention (K6) and SSD chunk (K7) against their plain "
             "versions")
    summary = run_lm_kernel_phase(torch, dev)

    phase(8, "serve Zamba2-1.2B, full width, bf16, 8 requests on 4 slots")
    launches = run_serve_phase(torch, dev)
    cfg = get_config(ARCH)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = model.init(gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device=dev)
    run_prefill_profile(torch, dev, model, params, tokens)
    run_mlp_timing(torch, dev, cfg, params, tokens.shape[1])
    run_decode_profile(torch, dev, model, params)

    phase(9, "full-width parity: kernel path against plain path")
    run_parity_phase(torch, dev, model, params, tokens)
    return summary, launches


# ------------------------------------------------------- phases 12-14

# the fp32 parity of phase 13 runs qwen3-14b at full width cut to this many
# layers: 40 fp32 layers (53 GB) would not fit beside the bf16 model
DENSE_FP32_LAYERS = 4
MOE_PARITY_TOKENS = 512
# the fp32 witness of phase 14 runs qwen2-moe-a2.7b at full width cut to
# this many layers (57 GB in fp32 at full depth)
MOE_FP32_LAYERS = 8


def dense_path_phases(torch, dev) -> dict[str, dict[str, int]]:
    """Phases 12-14: qwen3-14b served at full width, its kernel path
    against its plain path, then qwen2-moe-a2.7b served and held the same
    way; returns each serving run's K6/K7 launch counts by arch."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    phase(12, f"serve {DENSE_ARCH}, full width, bf16, 8 requests on 4 slots")
    launches = {DENSE_ARCH: run_serve_phase(torch, dev, DENSE_ARCH, 8)}
    free_device_memory(torch)
    cfg = get_config(DENSE_ARCH)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = model.init(gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device=dev)
    run_prefill_profile(torch, dev, model, params, tokens)
    run_decode_profile(torch, dev, model, params)

    phase(13, f"{DENSE_ARCH} parity: kernel path against plain path")
    run_parity_phase(torch, dev, model, params, tokens, arch=DENSE_ARCH,
                     fp32_layers=DENSE_FP32_LAYERS)
    del params
    free_device_memory(torch)

    phase(14, f"serve {MOE_ARCH}, full width, bf16, 4 requests on 4 slots; "
              f"kernel path against plain path")
    launches[MOE_ARCH] = run_serve_phase(torch, dev, MOE_ARCH, 4)
    free_device_memory(torch)
    cfg = get_config(MOE_ARCH)
    run_moe_parity(torch, dev, cfg.replace(dtype="float32",
                                           param_dtype="float32",
                                           n_layers=MOE_FP32_LAYERS))
    run_moe_parity(torch, dev, cfg)
    return launches


def moe_prefills(torch, model, params, batch, max_len: int):
    """Prefill logits of the kernel path, the plain path, and the plain path
    replaying the kernel path's expert choices (gates from its own
    probabilities); and the experts each free-running path chose, a
    (G, T, k) tensor per layer."""
    from repro_torch.models import moe

    top_k = moe.top_k
    runs: dict[str, list] = {"kernel": [], "plain": []}

    def recording(into):
        def pick(probs, k):
            gate, expert = top_k(probs, k)
            into.append(expert)
            return gate, expert
        return pick

    def replaying(choices):
        it = iter(choices)

        def pick(probs, k):
            expert = next(it)
            return probs.gather(-1, expert), expert
        return pick

    try:
        moe.top_k = recording(runs["kernel"])
        lk, _ = model.prefill(params, batch, max_len)
        moe.top_k = recording(runs["plain"])
        lp, _ = model.prefill(params, batch, max_len, mode="ref")
        moe.top_k = replaying(runs["kernel"])
        lpin, _ = model.prefill(params, batch, max_len, mode="ref")
    finally:
        moe.top_k = top_k
    return lk, lp, lpin, runs["kernel"], runs["plain"]


def flip_shares(kernel: list, plain: list) -> list[float]:
    """Per layer, the share of tokens whose set of k experts differs
    between the two paths."""
    return [float((a.sort(-1).values != b.sort(-1).values).any(-1)
                  .float().mean()) for a, b in zip(kernel, plain)]


def run_moe_parity(torch, dev, cfg) -> None:
    """The MoE's kernel path against its plain path at MOE_PARITY_TOKENS
    tokens.  Where a token's router probabilities sit within the paths'
    difference at the k-th place, its experts flip and its output moves by
    whole experts; later layers see the moved hidden state, so flips
    cascade.  Printed: the share of tokens whose experts flip, per layer
    (layer 0's differ only through attention, before any flip).  fp32:
    the paths differ by K6's fp32 roundings, so free-running logits are
    held within 1e-3 of the largest.  bf16: the free-running logits and
    greedy token are printed only; the plain path then replays the kernel
    path's choices, which leaves only the roundings, held to the bf16
    logit bar and greedy-token rule."""
    from repro_torch.models.api import get_model

    model = get_model(cfg)
    what = (f"{MOE_ARCH} {cfg.dtype} {MOE_PARITY_TOKENS}-token prefill, "
            f"{cfg.n_layers} layers")
    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(0)
        params = model.init(gen, dev)
        toks = torch.randint(0, cfg.vocab_size, (1, MOE_PARITY_TOKENS),
                             generator=gen, device=dev)
        lk, lp, lpin, ck, cp = moe_prefills(
            torch, model, params, {"tokens": toks}, MOE_PARITY_TOKENS + 16)
    del params
    free_device_memory(torch)
    shares = flip_shares(ck, cp)
    total = sum(shares) / len(shares)
    print(f"{what}, expert choices that differ between the paths, % of "
          f"tokens by layer: " + " ".join(f"{100 * f:.2f}" for f in shares)
          + f"; all layers {100 * total:.2f}%")
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    tk, tp = int(torch.argmax(lk[0, -1])), int(torch.argmax(lp[0, -1]))
    if cfg.dtype == "float32":
        print(f"{what}, free-running: max |dlogit| {diff:.3e} of max |logit| "
              f"{scale:.3f} = {diff / scale:.3e} (<= 1e-3); greedy token "
              f"kernel {tk} plain {tp}")
        check(diff <= 1e-3 * scale,
              "fp32 MoE kernel-path logits disagree with the plain path")
        return
    print(f"{what}, free-running (printed, not held: the flips): max "
          f"|dlogit| {diff:.4e} of max |logit| {scale:.3f} = "
          f"{diff / scale:.3e}; greedy token kernel {tk} plain {tp}")
    bf16_logit_check(torch, lk, lpin, f"{what}, the kernel path's expert "
                                      f"choices replayed")


# ------------------------------------------------------- phases 15-17

# phase 16's prompt: encoder frames and decoder tokens, bf16; its fp32
# parity halves both
ENCDEC_FRAMES, ENCDEC_TOKENS, ENCDEC_STEPS = 1024, 512, 16
# phase 17 runs qwen2-vl-72b at full width cut to this many of its 80
# layers: the 8 layers and the two 152064 x 8192 tables are 9.5 B
# parameters (19 GB in bf16); all 80 layers would need ~144 GB
VLM_LAYERS = 8
VLM_GRID = (1, 32, 64)      # (t, h, w) patches: 2048 positions
VLM_STEPS = 8


def run_prefill_path(torch, dev, cfg, model, params, batch, max_len: int,
                     steps: int, what: str) -> dict[str, int]:
    """One model through ``get_model(cfg)``'s prefill and decode steps: a
    timed prefill (after a warm-up) whose K6/K7 launches must equal
    ``launches_per_prefill(cfg)`` (counters reset just before), ``steps``
    greedy decode steps, the peak memory, a profiled prefill and decode
    step, and the bf16 kernel path against the plain path (the logit bar
    and greedy-token rule).  Returns the prefill's launch counts."""
    from repro_torch.kernels import ops

    with torch.inference_mode():
        model.prefill(params, batch, max_len)      # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, max_len)
        torch.cuda.synchronize()
        ttft = (time.perf_counter() - t0) * 1e3
        launches = {n: ops.launch_counts()[n] for n in LM_KERNELS}
        t0 = time.perf_counter()
        toks = _greedy(torch, model, params, logits, cache, steps)
        torch.cuda.synchronize()
        tpot = (time.perf_counter() - t0) * 1e3 / steps
    per = launches_per_prefill(cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    peak = torch.cuda.max_memory_allocated()
    print(f"{what}: {n_params / 1e9:.3f} B parameters; prefill {ttft:.3f} "
          f"ms, then {steps} greedy decode steps at {tpot:.3f} ms each (host "
          f"clock); tokens {toks[:8]}; launches {launches} (expected {per})")
    print(f"peak device memory {peak / 1e9:.3f} GB (< 80 GB)")
    check(launches == per, f"{what}: launches {launches}, expected {per}")
    check(peak < 80e9, f"peak device memory {peak / 1e9:.3f} GB >= 80 GB")
    run_prefill_profile(torch, dev, model, params, None, batch=batch,
                        max_len=max_len, what=f"{what} prefill")
    with torch.inference_mode():
        _, cache = model.prefill(params, batch, max_len)
    run_decode_profile(torch, dev, model, params, cache)
    del cache
    with torch.inference_mode():
        lk, _ = model.prefill(params, batch, max_len)
        lp, _ = model.prefill(params, batch, max_len, mode="ref")
    bf16_logit_check(torch, lk, lp, f"{what} bf16 prefill")
    return launches


def ssm_path_phase(torch, dev) -> dict[str, int]:
    """Phase 15: mamba2-2.7b served at full width and depth, a profiled
    2048-token prefill and decode step, and its kernel path against its
    plain path (fp32 at 512 tokens, bf16 at 2048); returns the serving
    run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    launches = run_serve_phase(torch, dev, SSM_ARCH, 8)
    free_device_memory(torch)
    cfg = get_config(SSM_ARCH)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = model.init(gen, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{SSM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.ssm_heads} heads of {cfg.ssm_headdim}, N {cfg.ssm_state}, "
          f"{n_params / 1e9:.3f} B parameters")
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device=dev)
    run_prefill_profile(torch, dev, model, params, tokens)
    run_decode_profile(torch, dev, model, params)
    run_fp32_parity(torch, dev, tokens, SSM_ARCH)
    run_ssm_bf16_parity(torch, cfg, model, params, tokens)
    del params
    free_device_memory(torch)
    return launches


# how far the free-running bf16 kernel path may drift from the plain path,
# as a multiple of the plain path's own drift when its intra-chunk sum runs
# in another fp32 order (the noise floor of the model's bf16 roundings)
SSM_DRIFT_FACTOR = 2.0


def reordered_ssd_chunk_ref(x, dt_a, b, c):
    """The plain version of K7 (``ref.ssd_chunk_ref``) with its y sum over
    the chunk's source rows taken in two halves and then added: the same
    function, equally exact in fp32, rounded elsewhere."""
    import torch

    q = x.shape[1]
    xf, bf = x.float(), b.float()
    cs = torch.cumsum(dt_a.float(), dim=1)
    seg = cs[:, :, None, :] - cs[:, None, :, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    lmat = torch.where(mask[None, :, :, None], torch.exp(seg),
                       torch.zeros((), device=x.device))
    w = torch.einsum("bthn,bshn->btsh", c.float(), bf) * lmat
    half = q // 2
    y = (torch.einsum("btsh,bshp->bthp", w[:, :, half:], xf[:, half:])
         + torch.einsum("btsh,bshp->bthp", w[:, :, :half], xf[:, :half]))
    state = torch.einsum("bshn,bsh,bshp->bhpn", bf,
                         torch.exp(cs[:, -1:, :] - cs), xf)
    return y.to(x.dtype), state, torch.exp(cs)


def run_ssm_bf16_parity(torch, cfg, model, params, tokens) -> None:
    """The Mamba2 LM's bf16 kernel path against its plain path at 2048
    tokens.  Free-running, a one-ulp flip of a bf16 rounding in one layer
    moves every later layer's input, and 64 layers of random weights
    amplify it: the plain path with its own intra-chunk sum reordered
    (``reordered_ssd_chunk_ref``) drifts about as far as the kernel path.
    So the free-running logits are held to the greedy-token rule and to
    BF16_LOGIT_RTOL of the largest logit or, where the noise floor is above
    half that, to SSM_DRIFT_FACTOR times the floor; and BF16_LOGIT_RTOL
    holds layer by layer: each layer of the kernel path, fed the plain
    path's hidden state, within it of the plain layer's largest output."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.models.tree import layer

    what = f"{SSM_ARCH} bf16 {tokens.shape[1]}-token prefill"
    batch, max_len = {"tokens": tokens}, tokens.shape[1] + 16
    plain_ssd = ref.ssd_chunk_ref
    with torch.inference_mode():
        lk, _ = model.prefill(params, batch, max_len)
        lp, _ = model.prefill(params, batch, max_len, mode="ref")
        try:
            ref.ssd_chunk_ref = reordered_ssd_chunk_ref
            lo, _ = model.prefill(params, batch, max_len, mode="ref")
        finally:
            ref.ssd_chunk_ref = plain_ssd
        h = L.embed(params["embedding"], tokens)
        per_layer = []
        for i in range(cfg.n_layers):
            lp_i = layer(params["layers"], i)
            hk = M.block_apply(lp_i, h, cfg)
            h = M.block_apply(lp_i, h, cfg, mode="ref")
            per_layer.append(((hk.float() - h.float()).abs().max()
                              / h.float().abs().max()).item())
    scale = lp.abs().max().item()
    drift = (lk - lp).abs().max().item()
    floor = (lo - lp).abs().max().item()
    top2 = torch.topk(lp[0, -1], 2).values
    gap = (top2[0] - top2[1]).item()
    tk, tp = int(torch.argmax(lk[0, -1])), int(torch.argmax(lp[0, -1]))
    bar = max(BF16_LOGIT_RTOL * scale, SSM_DRIFT_FACTOR * floor)
    print(f"{what}, free-running: max |dlogit| {drift:.4e} of max |logit| "
          f"{scale:.3f} = {drift / scale:.3e}; the plain path with its "
          f"intra-chunk sum reordered: {floor / scale:.3e} (noise floor), "
          f"the kernel path at {drift / max(floor, 1e-30):.2f} times it; "
          f"held to {bar / scale:.3e} (the larger of {BF16_LOGIT_RTOL:g} and "
          f"{SSM_DRIFT_FACTOR:g} x the floor); plain top-2 gap {gap:.4e}; "
          f"greedy token kernel {tk} plain {tp}")
    check(drift <= bar, "bf16 kernel-path logits drift past the larger of "
                        "the logit bar and twice the noise floor")
    if gap > 2 * drift:
        check(tk == tp, "bf16 greedy token differs where the top-2 gap "
                        "exceeds twice the logit difference")
    worst = max(per_layer)
    print(f"{what}, layer by layer (each kernel-path layer fed the plain "
          f"path's hidden state), max |dh| / max |h| by layer: "
          + " ".join(f"{r:.1e}" for r in per_layer[::8])
          + f"; worst {worst:.3e} (<= {BF16_LOGIT_RTOL:g})")
    check(worst <= BF16_LOGIT_RTOL,
          "a bf16 kernel-path layer disagrees with the plain path")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _greedy(torch, model, params, logits, cache, steps: int) -> list[int]:
    """``steps`` greedy decode steps from a prefill's logits and cache; the
    tokens chosen (of row 0)."""
    out = []
    for _ in range(steps):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(int(tok[0, 0]))
        logits, cache = model.decode_step(params, cache, {"tokens": tok})
    return out


def encdec_batch(torch, dev, cfg, gen, frames: int, tokens: int) -> dict:
    """Random frame embeddings (the front end's stub, at the scale of the
    token embeddings) and decoder tokens."""
    emb = torch.randn((1, frames, cfg.d_model), generator=gen, device=dev)
    return {"enc_embeds": (emb * 0.02).to(getattr(torch, cfg.dtype)),
            "dec_tokens": torch.randint(0, cfg.vocab_size, (1, tokens),
                                        generator=gen, device=dev)}


def encdec_path_phase(torch, dev) -> dict[str, int]:
    """Phase 16: seamless-m4t-large-v2 at full width and depth through
    ``get_model(cfg).prefill``/``decode_step`` (the serving runner refuses
    the encoder-decoder, as the reference's does), then in fp32 at full
    width and depth on half the frames and tokens; returns the launch
    counts of the measured prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    cfg = get_config(ENCDEC_ARCH)
    model = get_model(cfg)
    print(f"{ENCDEC_ARCH}: {cfg.n_encoder_layers} + {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}; {ENCDEC_FRAMES} frames, "
          f"{ENCDEC_TOKENS} tokens")
    gen = torch.Generator(device=dev).manual_seed(0)
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        params = model.init(gen, dev)
        batch = encdec_batch(torch, dev, cfg, gen, ENCDEC_FRAMES,
                             ENCDEC_TOKENS)
    launches = run_prefill_path(torch, dev, cfg, model, params, batch,
                                ENCDEC_TOKENS + 32, ENCDEC_STEPS,
                                f"{ENCDEC_ARCH} {ENCDEC_FRAMES}-frame, "
                                f"{ENCDEC_TOKENS}-token")
    del params
    free_device_memory(torch)
    # fp32 at full width and depth: 512 frames / 256 tokens, 8 greedy steps
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    m32 = get_model(cfg32)
    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(1)
        p32 = m32.init(gen, dev)
        b32 = encdec_batch(torch, dev, cfg32, gen, ENCDEC_FRAMES // 2,
                           ENCDEC_TOKENS // 2)
        lk, ck = m32.prefill(p32, b32, ENCDEC_TOKENS // 2 + 16)
        lp, cp = m32.prefill(p32, b32, ENCDEC_TOKENS // 2 + 16, mode="ref")
        for step in range(9):
            diff = (lk - lp).abs().max().item()
            scale = lp.abs().max().item()
            print(f"{ENCDEC_ARCH} fp32 {ENCDEC_FRAMES // 2} frames, "
                  f"{ENCDEC_TOKENS // 2} tokens, "
                  f"{'prefill' if step == 0 else f'decode {step}'}: max "
                  f"|dlogit| {diff:.3e} of max |logit| {scale:.3f} = "
                  f"{diff / scale:.3e} (<= 1e-3)")
            check(diff <= 1e-3 * scale, "fp32 encoder-decoder kernel-path "
                                        "logits disagree with the plain path")
            if step == 8:
                break
            tok = torch.argmax(lp[:, -1], dim=-1)[:, None]
            lk, ck = m32.decode_step(p32, ck, {"tokens": tok})
            lp, cp = m32.decode_step(p32, cp, {"tokens": tok})
        for key in ("k", "v", "mem_k", "mem_v"):
            a, r = errors(ck[key], cp[key])
            print(f"fp32 cache {key}: max_abs {a:.3e} max_rel {r:.3e}")
    del p32, ck, cp
    free_device_memory(torch)
    return launches


def vlm_path_phase(torch, dev) -> dict[str, int]:
    """Phase 17: qwen2-vl-72b at full width cut to VLM_LAYERS layers, a
    prefill of an image grid's embeddings at their M-RoPE positions and
    greedy decode steps, its bf16 kernel path against its plain path;
    returns the launch counts of the measured prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models import vlm
    from repro_torch.models.api import get_model

    full = get_config(VLM_ARCH)
    cfg = full.replace(n_layers=VLM_LAYERS)
    print(f"{VLM_ARCH} at full width (d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads on {cfg.n_kv_heads} KV heads of {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, M-RoPE {cfg.mrope_sections}), cut to "
          f"{VLM_LAYERS} of {full.n_layers} layers: all of them would need "
          f"~144 GB in bf16")
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    t, h, w = VLM_GRID
    with torch.inference_mode():
        params = model.init(gen, dev)
        emb = torch.randn((1, t * h * w, cfg.d_model), generator=gen,
                          device=dev)
        batch = {"embeds": (emb * 0.02).to(torch.bfloat16),
                 "positions": vlm.make_image_positions(1, t, h, w, dev)}
    launches = run_prefill_path(torch, dev, cfg, model, params, batch,
                                t * h * w + 16, VLM_STEPS,
                                f"{VLM_ARCH} ({VLM_LAYERS} layers) "
                                f"{t}x{h}x{w}-patch grid")
    del params
    free_device_memory(torch)
    return launches


def family_path_phases(torch, dev) -> dict[str, dict[str, int]]:
    """Phases 15-17; returns each path's K6/K7 launch counts by arch (the
    serving run's for mamba2-2.7b, one prefill's for the others)."""
    phase(15, f"serve {SSM_ARCH}, full width, bf16, 8 requests on 4 slots; "
              f"kernel path against plain path")
    launches = {SSM_ARCH: ssm_path_phase(torch, dev)}
    phase(16, f"{ENCDEC_ARCH}, full width, bf16: prefill of "
              f"{ENCDEC_FRAMES} frames and {ENCDEC_TOKENS} tokens, "
              f"{ENCDEC_STEPS} decode steps; kernel path against plain path")
    launches[ENCDEC_ARCH] = encdec_path_phase(torch, dev)
    phase(17, f"{VLM_ARCH}, full width cut to {VLM_LAYERS} layers, bf16: "
              f"image-grid prefill, {VLM_STEPS} decode steps; kernel path "
              f"against plain path")
    launches[VLM_ARCH] = vlm_path_phase(torch, dev)
    return launches


# -------------------------------------------------------------- phase 18

TRAIN_ARCH = "granite-3-2b"
TRAIN_HYBRID_ARCH = "zamba2-1.2b"
TRAIN_SEQ = 2048
TRAIN_STEPS = 5           # AdamW steps of granite-3-2b, microbatches 2
TRAIN_INT8_STEPS = 3      # then with int8 error feedback
TRAIN_HYBRID_STEPS = 3    # Zamba2-1.2B, batch 1
# the kernel path against the plain path (the loss's K4/K5 against their
# plain versions) on granite's first step: the loss (fp32 sums of 49408
# classes in another order) and the global gradient norm (the fp32
# dlogits, a few ulps apart, become bf16 gradients of the hidden states,
# whose roundings then differ through 40 layers: 2.8e-4 measured)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-2


def gemm_f32_backward_ms(torch, dev, m: int, k: int, n: int
                         ) -> tuple[float, float]:
    """Device ms of the backward of a bf16 (m, k) @ (k, n) product written
    in fp32, for an fp32 cotangent: as the port runs it
    (``layers.gemm_f32_grads``: the cotangent split into bf16 hi + lo, two
    GEMMs a product) and with the cotangent rounded once to bf16 (one GEMM
    a product)."""
    from repro_torch.models.layers import gemm_f32_grads

    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
    w = torch.randn(k, n, generator=gen, device=dev).bfloat16()
    g = torch.randn(m, n, generator=gen, device=dev)

    def once():
        gb = g.bfloat16()
        return torch.mm(gb, w.t()), torch.mm(x.t(), gb)

    return (device_ms(lambda: gemm_f32_grads(x, w, g, torch.mm), iters=5,
                      replays=5),
            device_ms(once, iters=5, replays=5))


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def train_batch(torch, dev, cfg, batch: int, gen):
    """``batch`` rows of TRAIN_SEQ + 1 seeded token ids: tokens and their
    next-token labels."""
    tok = torch.randint(0, cfg.vocab_size, (batch, TRAIN_SEQ + 1),
                        generator=gen, device=dev, dtype=torch.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def run_train(torch, model, settings, state, batch, steps: int,
              k45_per_step: int, what: str, mode=None):
    """``steps`` steps of ``launch.steps.build_train_step``: per step the
    loss, the gradient norm, host ms (synchronised) and the launches
    (counters reset just before the step, read just after); K4 and K5
    must launch ``k45_per_step`` times a step (0 on the plain path), K6 and
    K7 never (they have no backward: attention and the SSD train on their
    plain versions).  Returns (the state after the steps, the rows)."""
    import math

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step

    step = build_train_step(model, settings, mode=mode)
    out = []
    for i in range(steps):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
        row = {"loss": metrics["loss"].item(),
               "grad_norm": metrics["grad_norm"].item(), "ms": ms,
               "launches": launches}
        out.append(row)
        print(f"{what} step {i + 1}: loss {row['loss']:.6f} grad_norm "
              f"{row['grad_norm']:.6f} host {ms:.1f} ms; K4 "
              f"{launches['softmax_xent_fwd']} K5 "
              f"{launches['softmax_xent_dlogits']} K6 "
              f"{launches['flash_attention']} K7 {launches['ssd_chunk']}",
              flush=True)
        check(math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"]),
              f"{what}: step {i + 1} is not finite")
        check(launches["softmax_xent_fwd"] == k45_per_step
              and launches["softmax_xent_dlogits"] == k45_per_step,
              f"{what}: K4/K5 launched {launches['softmax_xent_fwd']}/"
              f"{launches['softmax_xent_dlogits']} times in a step, expected "
              f"{k45_per_step}")
        check(launches["flash_attention"] == 0 and launches["ssd_chunk"] == 0,
              f"{what}: K6/K7 launched in a train step")
    if steps > 1:
        check(out[-1]["loss"] < out[0]["loss"],
              f"{what}: the loss did not fall ({out[0]['loss']:.6f} -> "
              f"{out[-1]['loss']:.6f})")
    return state, out


def profile_train_step(torch, step) -> tuple[float, list]:
    """Device busy ms of one train step from torch.profiler, and its
    device operations (name, count, us), largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = sorted(device_rows(prof), key=lambda r: -r[2])
    busy = sum(us for _, _, us in rows) / 1e3
    return busy or float("nan"), rows


def fwd_bwd_ms(torch, fn, inputs, reps: int = 5) -> tuple[float, float]:
    """(forward ms, forward + backward ms) of ``fn(*inputs)`` under
    autograd, CUDA events over ``reps`` calls after a warm-up."""
    leaves = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]

    def fwd():
        return fn(*leaves)

    def both():
        out = fn(*leaves)
        out = out[0] if isinstance(out, tuple) else out
        out.float().sum().backward()

    times = []
    for f in (fwd, both):
        f()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            f()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times[0], times[1]


def print_profile(what: str, busy: float, host_ms: float, rows) -> None:
    if not rows:
        print(f"{what}: device time not measured (the profiler recorded no "
              f"device events)")
        return
    print(f"{what}: device busy {busy:.3f} ms of {host_ms:.3f} ms host "
          f"({100 * busy / host_ms:.1f}%; idle "
          f"{100 - 100 * busy / host_ms:.1f}%), "
          f"{sum(c for _, c, _ in rows)} device operations")
    for key, count, us in rows[:12]:
        print(f"  {us / 1e3:9.3f} ms {count:5d} calls  {key[:100]}")


def granite_train_phase(torch, dev, smi: str) -> dict:
    """Phase 18a: granite-3-2b at full width and depth trained by
    ``build_train_step``; returns K4/K5's launches and numbers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (TrainSettings, build_train_step,
                                          init_train_state)
    from repro_torch.models import layers as L
    from repro_torch.models.api import get_model

    cfg = get_config(TRAIN_ARCH)
    model = get_model(cfg)
    settings = TrainSettings(microbatches=2)
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, settings,
                             torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    batch = train_batch(torch, dev, cfg, 2,
                        torch.Generator(device=dev).manual_seed(1))
    print(f"{TRAIN_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads on {cfg.n_kv_heads} KV heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"padded to {cfg.padded_vocab}, tied; {n_params / 1e9:.3f} B "
          f"parameters in {cfg.param_dtype}, fp32 moments, remat "
          f"{cfg.remat} ({cfg.remat_policy}); batch 2 x {TRAIN_SEQ}, "
          f"microbatches 2 (K4 at ({TRAIN_SEQ}, {cfg.padded_vocab}) each)")
    state, rows = run_train(torch, model, settings, state, batch,
                            TRAIN_STEPS, 2, TRAIN_ARCH)
    peak = torch.cuda.max_memory_allocated()
    gb = 1e9
    p_bytes = _tree_bytes(state["params"])
    m_bytes = _tree_bytes(state["opt"])
    logits = 2 * TRAIN_SEQ * cfg.padded_vocab * 4
    print(f"memory reckoned: parameters {p_bytes / gb:.2f} GB, gradients "
          f"{p_bytes / gb:.2f}, moments {m_bytes / gb:.2f}, fp32 logits and "
          f"dlogits of a microbatch {logits / gb:.2f}, plus one layer's "
          f"recompute = {(2 * p_bytes + m_bytes + logits) / gb:.2f} GB and "
          f"up; measured peak {peak / gb:.3f} GB "
          f"(torch.cuda.max_memory_allocated; < 80 GB)")
    check(peak < 80e9, f"{TRAIN_ARCH} train peak {peak / gb:.3f} GB >= 80 GB")
    host = sorted(r["ms"] for r in rows[1:])
    host_ms = host[len(host) // 2]
    step = build_train_step(model, settings)

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    busy, prof_rows = profile_train_step(torch, one_step)
    print_profile(f"{TRAIN_ARCH} train step (profiled, one step; host ms the "
                  f"median of steps 2-{TRAIN_STEPS})", busy, host_ms,
                  prof_rows)
    # the plain attention of one layer at the step's shape, forward and
    # forward + backward, alone: x n_layers x 2 microbatches, its forward
    # twice (the remat recomputes it)
    hd, h, kv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    gen = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, cfg.dtype)
    q = torch.randn(1, h, TRAIN_SEQ, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(1, kv, TRAIN_SEQ, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(1, kv, TRAIN_SEQ, hd, generator=gen, device=dev).to(dt)
    from repro_torch.kernels import ops

    f_ms, fb_ms = fwd_bwd_ms(torch, lambda q, k, v: ops.flash_attention(
        q, k, v, True, mode="ref"), (q, k, v))
    attn = cfg.n_layers * 2 * (2 * f_ms + (fb_ms - f_ms))
    print(f"plain attention of one layer at (1, {h}, {TRAIN_SEQ}, {hd}) on "
          f"{kv} KV heads, alone: forward {f_ms:.3f} ms, forward+backward "
          f"{fb_ms:.3f} ms; x {cfg.n_layers} layers x 2 microbatches with "
          f"the recompute = {attn:.1f} ms = {100 * attn / busy:.1f}% of the "
          f"step's device busy time")
    del q, k, v
    xent = {n: sum(us for key, _, us in prof_rows if tag in key) / 1e3
            for n, tag in (("K4", "xent_fwd"), ("K4 mean", "xent_mean"),
                           ("K5", "xent_dlogits"))}
    print(f"K4/K5 in the profiled step: " + ", ".join(
        f"{n} {ms:.4f} ms" for n, ms in xent.items())
        + f" = {100 * sum(xent.values()) / busy:.2f}% of device busy")

    # kernel path against plain path, first step from the same weights
    del state, step
    free_device_memory(torch)
    state = init_train_state(model, settings,
                             torch.Generator(device=dev).manual_seed(0), dev)
    state, (plain,) = run_train(torch, model, settings, state, batch, 1, 0,
                                f"{TRAIN_ARCH} plain path", mode="ref")
    loss_rel = abs(rows[0]["loss"] - plain["loss"]) / abs(plain["loss"])
    gn_rel = (abs(rows[0]["grad_norm"] - plain["grad_norm"])
              / abs(plain["grad_norm"]))
    print(f"kernel path against plain path, step 1: loss "
          f"{rows[0]['loss']:.7f} vs {plain['loss']:.7f} (rel {loss_rel:.3e}"
          f" <= {TRAIN_LOSS_RTOL:g}); grad_norm {rows[0]['grad_norm']:.6f} "
          f"vs {plain['grad_norm']:.6f} (rel {gn_rel:.3e} <= "
          f"{TRAIN_GNORM_RTOL:g})")
    check(loss_rel <= TRAIN_LOSS_RTOL, "granite kernel/plain losses differ")
    check(gn_rel <= TRAIN_GNORM_RTOL, "granite kernel/plain grad norms differ")
    del state
    free_device_memory(torch)

    # int8 error feedback
    settings8 = TrainSettings(microbatches=2, grad_compression="int8")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, settings8,
                             torch.Generator(device=dev).manual_seed(0), dev)
    state, rows8 = run_train(torch, model, settings8, state, batch,
                             TRAIN_INT8_STEPS, 2, f"{TRAIN_ARCH} int8")
    peak8 = torch.cuda.max_memory_allocated()
    r_bytes = _tree_bytes(state["residual"])
    print(f"int8: residual {r_bytes / gb:.2f} GB (fp32), dequantized fp32 "
          f"grads {2 * p_bytes / gb:.2f} GB; measured peak {peak8 / gb:.3f} "
          f"GB (< 80 GB)")
    check(peak8 < 80e9, f"{TRAIN_ARCH} int8 peak {peak8 / gb:.3f} GB")
    del state
    free_device_memory(torch)
    # what the split cotangent costs: the gate and up products of each
    # layer and the unembedding, per microbatch
    t, d = TRAIN_SEQ, cfg.d_model
    mlp = gemm_f32_backward_ms(torch, dev, t, d, cfg.d_ff)
    emb = gemm_f32_backward_ms(torch, dev, t, d, cfg.padded_vocab)
    split_cost = 2 * (2 * cfg.n_layers * (mlp[0] - mlp[1]) + emb[0] - emb[1])
    print(f"backward of a bf16 product written in fp32, the cotangent split "
          f"(hi + lo) vs rounded once: gate/up ({t}, {d}) @ ({d}, "
          f"{cfg.d_ff}) {mlp[0]:.4f} vs {mlp[1]:.4f} ms, unembedding ({t}, "
          f"{d}) @ ({d}, {cfg.padded_vocab}) {emb[0]:.4f} vs {emb[1]:.4f} "
          f"ms; x (2 x {cfg.n_layers} layers + 1) x 2 microbatches = "
          f"{split_cost:.1f} ms a step ({100 * split_cost / busy:.1f}% of "
          f"device busy)")
    free_device_memory(torch)
    ms8 = sorted(r["ms"] for r in rows8[1:])
    print(f"{TRAIN_ARCH} train on {smi}: {host_ms:.1f} ms/step (batch 2 x "
          f"{TRAIN_SEQ}, 2 microbatches), device busy {busy:.1f} ms, peak "
          f"{peak / gb:.3f} GB; int8 {ms8[len(ms8) // 2]:.1f} ms/step, peak "
          f"{peak8 / gb:.3f} GB; loss {rows[0]['loss']:.4f} -> "
          f"{rows[-1]['loss']:.4f} over {TRAIN_STEPS} steps; plain attention "
          f"{100 * attn / busy:.1f}% of device busy")
    return {"launches": sum(r["launches"]["softmax_xent_fwd"] for r in rows),
            "steps": TRAIN_STEPS, "ms_per_step": host_ms, "busy_ms": busy,
            "attention_share": attn / busy}


def hybrid_train_phase(torch, dev, smi: str) -> None:
    """Phase 18b: Zamba2-1.2B at full width and depth, bf16, batch 1 x
    TRAIN_SEQ, TRAIN_HYBRID_STEPS steps; where a step's time goes, with the
    plain SSD's and the shared attention's shares."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (TrainSettings, build_train_step,
                                          init_train_state)
    from repro_torch.models import mamba2 as M
    from repro_torch.models import zamba2 as Z
    from repro_torch.models.api import get_model

    cfg = get_config(TRAIN_HYBRID_ARCH)
    model = get_model(cfg)
    settings = TrainSettings()
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, settings,
                             torch.Generator(device=dev).manual_seed(0), dev)
    batch = train_batch(torch, dev, cfg, 1,
                        torch.Generator(device=dev).manual_seed(1))
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    print(f"{TRAIN_HYBRID_ARCH}: {cfg.n_layers} Mamba2 layers and "
          f"{Z.n_shared_invocations(cfg)} shared-attention invocations, "
          f"{n_params / 1e9:.3f} B parameters, bf16, batch 1 x {TRAIN_SEQ}")
    state, rows = run_train(torch, model, settings, state, batch,
                            TRAIN_HYBRID_STEPS, 1, TRAIN_HYBRID_ARCH)
    peak = torch.cuda.max_memory_allocated()
    host = sorted(r["ms"] for r in rows[1:])
    host_ms = host[len(host) // 2]
    step = build_train_step(model, settings)

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    busy, prof_rows = profile_train_step(torch, one_step)
    print_profile(f"{TRAIN_HYBRID_ARCH} train step (profiled)", busy,
                  host_ms, prof_rows)
    del state, step
    free_device_memory(torch)
    # the plain SSD of one Mamba2 layer and the shared block's plain
    # attention at the step's shapes, alone, each forward and backward;
    # the Mamba layers recompute their forward (remat), the shared block
    # does not
    gen = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, cfg.dtype)
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    x = torch.randn(1, TRAIN_SEQ, h, p, generator=gen, device=dev).to(dt)
    dt_a = -torch.rand(1, TRAIN_SEQ, h, generator=gen, device=dev) * 0.1
    b = torch.randn(1, TRAIN_SEQ, 1, n, generator=gen, device=dev).to(dt)
    c = torch.randn(1, TRAIN_SEQ, 1, n, generator=gen, device=dev).to(dt)
    f_ms, fb_ms = fwd_bwd_ms(torch, lambda x, a, b, c: M.ssd_chunked(
        x, a, b, c, cfg.ssm_chunk, mode="ref"), (x, dt_a, b, c))
    ssd = cfg.n_layers * (2 * f_ms + (fb_ms - f_ms))
    hd = cfg.resolved_head_dim
    q = torch.randn(1, cfg.n_heads, TRAIN_SEQ, hd, generator=gen,
                    device=dev).to(dt)
    k = torch.randn(1, cfg.n_kv_heads, TRAIN_SEQ, hd, generator=gen,
                    device=dev).to(dt)
    af_ms, afb_ms = fwd_bwd_ms(torch, lambda q, k, v: ops.flash_attention(
        q, k, v, True, mode="ref"), (q, k, k.clone()))
    attn = Z.n_shared_invocations(cfg) * afb_ms
    print(f"plain SSD (ssd_chunked) of one layer at ({TRAIN_SEQ} tokens, {h} "
          f"heads of {p}, state {n}), alone: forward {f_ms:.3f} ms, "
          f"forward+backward {fb_ms:.3f} ms; x {cfg.n_layers} layers with "
          f"the recompute = {ssd:.1f} ms = {100 * ssd / busy:.1f}% of the "
          f"step's device busy time")
    print(f"plain attention of the shared block at (1, {cfg.n_heads}, "
          f"{TRAIN_SEQ}, {hd}), alone: forward {af_ms:.3f} ms, "
          f"forward+backward {afb_ms:.3f} ms; x "
          f"{Z.n_shared_invocations(cfg)} invocations = {attn:.1f} ms = "
          f"{100 * attn / busy:.1f}% of device busy")
    print(f"{TRAIN_HYBRID_ARCH} train on {smi}: {host_ms:.1f} ms/step "
          f"(batch 1 x {TRAIN_SEQ}), device busy {busy:.1f} ms, peak "
          f"{peak / 1e9:.3f} GB; loss {rows[0]['loss']:.4f} -> "
          f"{rows[-1]['loss']:.4f} over {TRAIN_HYBRID_STEPS} steps; plain SSD "
          f"{100 * ssd / busy:.1f}%, shared attention {100 * attn / busy:.1f}%"
          f" of device busy")
    check(peak < 80e9, f"{TRAIN_HYBRID_ARCH} train peak {peak / 1e9:.3f} GB")


def train_path_phase(torch, dev, smi: str) -> dict:
    """Phase 18; returns K4/K5's launches and numbers on the train path."""
    phase(18, f"lm train: {TRAIN_ARCH} full width, {TRAIN_STEPS} AdamW steps "
              f"(2 microbatches of {TRAIN_SEQ} tokens), {TRAIN_INT8_STEPS} "
              f"with int8 error feedback, kernel path against plain path; "
              f"{TRAIN_HYBRID_ARCH} full width, {TRAIN_HYBRID_STEPS} steps")
    out = granite_train_phase(torch, dev, smi)
    hybrid_train_phase(torch, dev, smi)
    return out


# -------------------------------------------------------------- phase 10

RING = 8    # logical devices of the executor's ring
# the programs phase 10 holds to the single-device path: (arch, strategy,
# batch); NN1's chunk shapes are timed, the others' only checked
PROGRAM_CHECKS = (("NN1", "orrm", 64), ("NN2", "fm", 64), ("NN2", "rrm", 64),
                  ("NN2", "orrm", 64), ("NN5", "orrm", 128))
# the reference executor's bars against the single-device path
# (tests/test_exec_runtime.py): sums in another order, by column chunk
EXEC_LOSS_RTOL = 1e-6
EXEC_GRAD_RTOL, EXEC_GRAD_ATOL = 1e-4, 1e-7


def program_of(arch: str, strategy: str, batch: int):
    from repro_torch.configs.nn_benchmarks import NN_BENCHMARKS
    from repro_torch.core.onoc_model import FCNNWorkload
    from repro_torch.exec import compile_fcnn_program
    from repro_torch.launch.train_fcnn import ONOC

    return compile_fcnn_program(
        FCNNWorkload(NN_BENCHMARKS[arch], batch_size=batch), ONOC, RING,
        strategy)


def chunk_label(arch: str, run) -> str:
    """The label run_kernel_phase gives the case of a RUN's chunk shape."""
    return f"{arch} P{run.layer} x{run.degree}"


def program_launches(prog) -> dict[str, int]:
    """Kernel launches one executor step makes: K1 and K3 once per window
    device and FP period, K2 at layers 2..l (layer 1's input needs no
    gradient), K4 and K5 once in the loss period."""
    degrees = [r.degree for r in prog.runs("fp")]
    return {"fcnn_layer": sum(degrees), "fcnn_layer_dgrad": sum(degrees[1:]),
            "fcnn_layer_wgrad": sum(degrees), "softmax_xent_fwd": 1,
            "softmax_xent_dlogits": 1}


def chunk_shapes(prog, arch: str, batch: int, timed: bool,
                 seen: set) -> list[tuple]:
    """kernel_cases' rows for the chunk shapes of ``prog``'s RUNs that are
    not in ``seen`` (which they join)."""
    shapes = []
    for run in prog.runs("fp"):
        key = (batch, prog.layer_sizes[run.layer - 1], run.chunk_width,
               run.activation)
        if key not in seen:
            seen.add(key)
            shapes.append((chunk_label(arch, run), *key, timed))
    return shapes


def run_chunk_kernels(torch, dev, summary) -> None:
    """K1-K3 at every chunk shape of PROGRAM_CHECKS' programs, held to
    their plain versions; NN1's timed, and summed over one executor step
    beside phase 3's single-device step."""
    shapes, seen, nn1 = [], set(), None
    for arch, strategy, batch in PROGRAM_CHECKS:
        prog = program_of(arch, strategy, batch)
        nn1 = nn1 or prog
        shapes += chunk_shapes(prog, arch, batch, arch == "NN1", seen)
    chunks = run_kernel_phase(torch, dev, shapes)
    for name in FCNN_KERNELS[:3]:
        total, calls = 0.0, 0
        for run in nn1.runs("fp"):
            if name == "fcnn_layer_dgrad" and run.layer == 1:
                continue
            k = nn1.layer_sizes[run.layer - 1]
            label = (f"{chunk_label('NN1', run)} L1 64x{k}x"
                     f"{run.chunk_width} {run.activation}")
            total += chunks[name]["rows"][label][0] * run.degree
            calls += run.degree
        print(f"NN1 ORRM executor step, {name}: kernel {total:.5f} ms over "
              f"{calls} chunk calls (single-device step, phase 3: "
              f"{summary[name]['ms']:.5f} ms over "
              f"{len(summary[name]['shapes'])} calls)")


def off_window_zero(exe, params) -> bool:
    return all(not lp[k][s].any()
               for lay, lp in zip(exe.executor._layout, params["layers"])
               for s, c in enumerate(lay.owner_chunk) if c is None
               for k in ("w", "b"))


def run_program_phase(torch, dev, summary) -> None:
    """Phase 10 (see the module docstring); ``summary`` is phase 3's."""
    from repro_torch import exec as pexec
    from repro_torch.configs.nn_benchmarks import NN_BENCHMARKS
    from repro_torch.core.onoc_model import FCNNWorkload
    from repro_torch.data import Batcher, fcnn_classification_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch.train_fcnn import (
        FULL_RUN_STEPS,
        LR,
        ONOC,
        train_program,
    )
    from repro_torch.models import fcnn
    from repro_torch.optim import adam, linear_warmup_cosine

    workload = FCNNWorkload(NN1, batch_size=64)
    exe = pexec.compile(workload, ONOC, RING, strategy="orrm",
                        residency="sharded", analyze="full", device=dev)
    prog = exe.program
    print(f"NN1 ORRM program on {RING} devices, analyzed at 'full': "
          f"{len(prog.instructions)} instructions, degrees "
          f"{list(prog.degrees)}, chunk widths "
          f"{[r.chunk_width for r in prog.runs('fp')]}, residency peak "
          f"ratio {exe.tracker.peak_ratio():.4f}")
    check(prog.degrees == (8, 4, 2), f"NN1 ORRM degrees {prog.degrees}")
    want = program_launches(prog)

    run_chunk_kernels(torch, dev, summary)

    print("train NN1 through the program, 300 steps, sharded, seed 0:")
    ops.reset_launches()
    out = train_program(arch="NN1", n_devices=RING, strategy="orrm",
                        residency="sharded", steps=FULL_RUN_STEPS, batch=64,
                        device=dev, seed=0)
    launches = ops.launch_counts()
    print(f"ms/step {out['ms_per_step']:.4f}  final train accuracy "
          f"{out['accuracy']:.4f}; launches in the run: {launches}")
    check(out["accuracy"] > 0.8, "the NN1 program failed to learn")
    for name in FCNN_KERNELS:
        check(launches[name] > 0, f"{name} was never launched by the program")
    check(off_window_zero(out["executable"], out["state"]["params"]),
          "an off-window slot is not zero after 300 steps")
    print("off-window slots after 300 steps: all exactly zero")

    opt = adam(linear_warmup_cosine(LR, 20, FULL_RUN_STEPS))
    x, y = fcnn_classification_dataset(4096, input_dim=NN1[0], seed=0)

    def stepper(e):
        state = e.init_state(torch.Generator().manual_seed(0), opt)
        step, batches = e.train_step(opt), Batcher({"x": x, "y": y}, 64, dev)
        return state, lambda: step(state, next(batches))[1]["loss"]

    _, step = stepper(exe)
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    ops.reset_launches()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    per_step = {k: v / 20 for k, v in ops.launch_counts().items()
                if k in FCNN_KERNELS}
    print("launches per executor step: " + ", ".join(
        f"{k} {v:g} (expected {want[k]})" for k, v in per_step.items()))
    check(per_step == want, "executor launches per step differ")
    host_ms, device_ops = profile_steps(torch, step)
    print(f"executor step: {device_ops:.1f} device operations/step, host "
          f"{host_ms:.4f} ms/step")
    executor = {"ms": out["ms_per_step"], "host_ms": host_ms,
                "ops": device_ops}

    # sharded against replicated, 5 Adam steps from the same weights
    e_s, e_r = (pexec.compile(workload, ONOC, RING, strategy="orrm",
                              residency=r, analyze="off", device=dev)
                for r in ("sharded", "replicated"))
    (s_s, step_s), (s_r, step_r) = stepper(e_s), stepper(e_r)
    l_s = torch.stack([step_s() for _ in range(5)])
    l_r = torch.stack([step_r() for _ in range(5)])
    same = torch.equal(l_s, l_r) and all(
        torch.equal(a, b) for a, b in zip(
            fcnn.parameters(e_s.gather_params(s_s["params"])),
            fcnn.parameters(s_r["params"])))
    print(f"5 Adam steps, sharded vs replicated: losses "
          f"{' '.join(f'{v:.7f}' for v in l_s.tolist())}; losses and "
          f"gathered parameters {'bit-identical' if same else 'DIFFER'}")
    check(same, "sharded and replicated runs differ")
    check(off_window_zero(e_s, s_s["params"]),
          "an off-window slot is not zero")

    for arch, strategy, batch in PROGRAM_CHECKS:
        sizes = NN_BENCHMARKS[arch]
        e = pexec.compile(FCNNWorkload(sizes, batch_size=batch), ONOC, RING,
                          strategy=strategy, residency="sharded", device=dev)
        params = fcnn.init(sizes, torch.Generator().manual_seed(0), dev)
        xb, yb = fcnn_classification_dataset(batch, input_dim=sizes[0],
                                             seed=3)
        b = {"x": torch.from_numpy(xb).to(dev),
             "y": torch.from_numpy(yb).to(dev)}
        loss_1 = fcnn.loss_fn(params, b)
        g_1 = torch.autograd.grad(loss_1, fcnn.parameters(params))
        sp = e.shard_params(params)
        loss_e = e.loss_fn(sp, b)
        gs = iter(torch.autograd.grad(loss_e, fcnn.parameters(sp)))
        g_e = fcnn.parameters(e.gather_params(
            {"layers": [{"w": next(gs), "b": next(gs)} for _ in sizes[1:]]}))
        d_loss = abs(loss_e.item() - loss_1.item()) / abs(loss_1.item())
        ok = d_loss <= EXEC_LOSS_RTOL and bool(torch.isfinite(loss_e))
        worst = 0.0
        for a, w in zip(g_e, g_1):
            excess = ((a - w).abs() / (EXEC_GRAD_ATOL + EXEC_GRAD_RTOL
                                       * w.abs())).max().item()
            worst = max(worst, excess)
        ok = ok and worst <= 1.0
        print(f"{arch} {strategy.upper()} batch {batch}, executor vs single "
              f"device: loss {loss_e.item():.7f} rel diff {d_loss:.3e} (<= "
              f"{EXEC_LOSS_RTOL:g}); gradients' worst |diff| / (atol + rtol"
              f"*|single|) {worst:.3f} (<= 1, rtol {EXEC_GRAD_RTOL:g}, atol "
              f"{EXEC_GRAD_ATOL:g}) {'ok' if ok else 'FAIL'}")
        check(ok, f"{arch} {strategy} executor disagrees with the single "
                  f"device path")
    return executor


# -------------------------------------------------------------- phase 11


# the repeated recovery: device losses, a run each, of RECOVERY_STEPS steps
# with a checkpoint every 10, losing devices 6 and 7 at step 25
RECOVERY_REPEATS, RECOVERY_STEPS = 5, 40


def run_recovery_phase(torch, dev, executor: dict, smi: str) -> None:
    """Phase 11 (see the module docstring); ``executor`` holds phase 10's
    numbers of the same program without the runner: ms/step over the
    300-step run, and the profiled step's host ms and device operations."""
    import statistics
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.onoc_model import FCNNWorkload
    from repro_torch.launch import elastic_restart as er
    from repro_torch.models import fcnn
    from repro_torch.optim import adam, linear_warmup_cosine
    from repro_torch.runtime import (
        DegradedModeRunner,
        FaultEvent,
        FaultKind,
        FaultSchedule,
    )

    print("scenario 1, crash and restart:")
    er.crash_restart(dev)
    print("scenario 2, elastic replanning:")
    er.elastic_shrink()
    sc = er.NN1_SCENARIO
    print(f"scenario 3: NN1 {list(sc.sizes)}, batch {er.BATCH}, "
          f"{sc.n_steps} steps, seed 0, ORRM on {er.N_DEVICES} devices, "
          f"sharded, a checkpoint every {sc.checkpoint_every} steps (async)")
    out = er.device_loss_replan_resume(sc, dev)
    faulted = out["faulted"]
    report, runner = faulted["report"], faulted["runner"]
    check(len(report.replans) == 1, f"replans {report.replans}")
    rp = report.replans[0]
    check((rp["from_devices"], rp["to_devices"]) == (8, 6),
          f"replan {rp['from_devices']} -> {rp['to_devices']}")
    check(runner.program.degrees == (2, 2, 2),
          f"survivor degrees {runner.program.degrees}")
    check(report.retries == 2, f"retries {report.retries}")
    check(report.kernel_fallbacks == 0,
          f"{report.kernel_fallbacks} kernel fallbacks")
    before, after = out["segments"]
    for seg, prog in ((before, program_of("NN1", "orrm", er.BATCH)),
                      (after, runner.program)):
        want = program_launches(prog)
        print(f"launches per step on {seg['devices']} devices: " + ", ".join(
            f"{k} {v:g} (expected {want[k]})"
            for k, v in seg["launches"].items()))
        check(seg["launches"] == want,
              f"launches per step on {seg['devices']} devices differ")
        check(all(v > 0 for v in seg["launches"].values()),
              f"a kernel was not launched on {seg['devices']} devices")
    check(faulted["accuracy"] > 0.8, "the recovered run failed to learn")

    repl = er.recovery_run(sc, out["schedule"], er.N_DEVICES, "replicated",
                           dev)
    same = repl["runner"].losses == runner.losses and all(
        torch.equal(a, b) for a, b in zip(
            fcnn.parameters(repl["state"]["params"]),
            fcnn.parameters(faulted["state"]["params"])))
    print(f"replicated residency, same schedule: losses and final params "
          f"{'bit-identical' if same else 'DIFFER'} to the sharded run")
    check(same, "sharded and replicated recovery differ")
    check(repl["report"].to_dict() == report.to_dict(),
          "sharded and replicated fault reports differ")

    # K1-K3 at the survivor program's chunk shapes, which phase 10's
    # 8-device programs do not give them, held to their plain versions
    print(f"K1-K3 at the chunk shapes of the {rp['to_devices']}-device "
          f"program (degrees {list(runner.program.degrees)}):")
    run_kernel_phase(torch, dev, chunk_shapes(runner.program, "NN1",
                                              er.BATCH, True, set()))

    # the recovery's spread: more device losses of 2 of 8, a run each
    lose = FaultSchedule(events=tuple(
        FaultEvent(kind=FaultKind.DEVICE_LOSS, step=25, period=2, device=d)
        for d in (6, 7)))
    short = er.Scenario(n_steps=RECOVERY_STEPS, checkpoint_every=10)
    recovery_s = out["recovery_s"][:1]
    for _ in range(RECOVERY_REPEATS):
        again = er.recovery_run(short, lose, er.N_DEVICES, "sharded", dev)
        check(again["report"].resumed_from == [19] and
              again["report"].kernel_fallbacks == 0,
              f"repeated recovery: {again['report'].to_dict()}")
        recovery_s += er.recovery_seconds(again["clock"])
    print(f"recovery over {len(recovery_s)} device losses (the 300-step "
          f"run's first): " + " ".join(f"{v:.4f}" for v in recovery_s)
          + f" s; median {statistics.median(recovery_s):.4f}, min "
          f"{min(recovery_s):.4f}, max {max(recovery_s):.4f} (host clock "
          f"from the draw of the faulted step to that of the first "
          f"resumed step)")

    print(f"recovery on {smi}: {out['recovery_s'][0]:.4f} s from the fault "
          f"to the first resumed step (replan, validate and analyze, "
          f"rebuild, restore), median {statistics.median(recovery_s):.4f} s "
          f"over {len(recovery_s)} losses; checkpoint "
          f"{faulted['checkpoint_bytes']} bytes, save "
          f"{1e3 * faulted['snapshot_s']:.3f} ms snapshot + "
          f"{1e3 * faulted['write_s']:.3f} ms write; runner ms/step "
          f"{before['ms']:.4f} on 8 devices, {after['ms']:.4f} on 6 "
          f"(phase 10's executor step without the runner: "
          f"{executor['ms']:.4f}); final train accuracy "
          f"{faulted['accuracy']:.4f}; resumed run against the from-scratch "
          f"run: losses {out['loss_excess']:.4f}, params "
          f"{out['param_excess']:.4f} of the bars")

    # where a runner's step time goes on each ring, beside phase 10's
    # executor step: fresh runners with no faults, each run() of
    # PROFILE_STEPS steps from the same weights (its build and one
    # checkpoint save included)
    params0 = fcnn.init(list(sc.sizes), torch.Generator().manual_seed(0),
                        dev)
    opt = adam(linear_warmup_cosine(er.LR, er.WARMUP, sc.n_steps))
    batches = er.synthetic_batches(list(sc.sizes), 4096, er.BATCH, dev)
    for n in (6, 8):
        def steps(k: int, n=n) -> None:
            with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as d:
                DegradedModeRunner(
                    workload=FCNNWorkload(list(sc.sizes), batch_size=er.BATCH),
                    base_cfg=er.ONOC, schedule=FaultSchedule(),
                    checkpointer=Checkpointer(d), optimizer=opt,
                    n_devices=n, residency="sharded",
                    checkpoint_every=sc.checkpoint_every, backoff_s=0.0,
                    device=dev).run(params0, opt.init(params0), batches, k)
            torch.cuda.synchronize()

        print(f"runner.run() on {n} devices, no faults:")
        host_ms, device_ops = profile_runs(torch, steps)
        builds = []
        for _ in range(3):   # a run() of no step: its build and set-up
            t0 = time.perf_counter()
            steps(0)
            builds.append(time.perf_counter() - t0)
        build_s = statistics.median(builds)
        print(f"runner.run() on {n} devices: {device_ops:.1f} device "
              f"operations/step, host {host_ms:.4f} ms/step, "
              f"{host_ms - 1e3 * build_s / PROFILE_STEPS:.4f} without the "
              f"build of each run() ({build_s:.4f} s, median of 3 run()s of "
              f"0 steps: replan, validate and analyze, executor, copies of "
              f"the state) (phase 10's executor step on 8: "
              f"{executor['ops']:.1f}, {executor['host_ms']:.4f} ms/step)")


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
    from repro_torch.kernels import ops

    run_build_phase()

    phase(3, "kernels against their plain versions")
    summary = run_kernel_phase(torch, dev)
    run_floor_and_chain(torch, dev, summary)

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
    for name in FCNN_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched by the training run")

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

    lm_summary, lm_launches = lm_path_phases(torch, dev)

    phase(10, "NN1 through its ORRM period program on an 8-device virtual "
              "ring")
    executor = run_program_phase(torch, dev, summary)

    phase(11, "NN1's ORRM program loses 2 of its 8 devices: replan to 6 "
              "and resume from a checkpoint")
    run_recovery_phase(torch, dev, executor, smi)

    dense_launches = dense_path_phases(torch, dev)
    family_launches = family_path_phases(torch, dev)
    train = train_path_phase(torch, dev, smi)

    kernels = []
    for name in FCNN_KERNELS:
        source, replaces = KERNEL_INFO[name]
        s = summary[name]
        extra = {}
        if name in XENT_KERNELS:
            ms, plain_ms, lib_ms, b_ms = s["rows"][LM_XENT_LABEL]
            extra["paths"] = {f"{TRAIN_ARCH} train": {
                "launches": train["launches"], "steps": train["steps"],
                "shape": LM_XENT_LABEL, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": "bytes"}}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"]
            else "operations",
            "library_ms": s["library_ms"],
            "shapes": s["shapes"],
            "per": "sum over one NN1 training step",
            **extra,
        })
    for name in LM_KERNELS:
        source, replaces = KERNEL_INFO[name]
        s = lm_summary[name]
        paths = s["paths"]
        for arch, counts in ((ARCH, lm_launches), *dense_launches.items(),
                             *family_launches.items()):
            if counts[name]:
                paths.setdefault(arch, {})["launches"] = counts[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": lm_launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "shapes": s["shapes"],
            "per": "call at the 2048-token prefill shape",
            "paths": paths,
        })
    print("\nper-kernel numbers: K1-K5 device times summed over the calls "
          "of one NN1 training step (the [NN1 step] lines of phase 3); K6/K7 "
          "per call at the shape of a 2048-token Zamba2 prefill (the "
          "[zamba2-1.2b serving path] lines of phase 7), launches from "
          "phases 5 and 8; under \"paths\", K6 and K7 at each path's "
          "prefill shape (phase 7; seamless-m4t-large-v2: its "
          "cross-attention) and their launches in that path's serving run "
          "(phases 8, 12, 14 and 15) or one prefill (phases 16 and 17); "
          "under K4/K5's \"paths\", their call at the LM loss's shape "
          "(phase 3) and their launches in phase 18's granite-3-2b steps")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
