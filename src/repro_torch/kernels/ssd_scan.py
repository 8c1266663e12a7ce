"""Wrapper of the Mamba2 SSD intra-chunk kernel (``csrc/ssd_scan.cu``).

  ssd_chunk  (y_diag, chunk state, exp(cumsum dt_a)) per chunk   replaces repro/kernels/ssd_scan.py:60

Checks device, dtype (x, b and c fp32 or bf16, of one dtype; dt_a
fp32), shapes and strides, then picks by the tensors' device: on
CUDA it allocates the three outputs, launches the kernel on the current
stream (all chunks and heads in one launch) and adds one to ``launches``;
on the CPU it runs the plain version from ``ref.py``; on the meta
device it returns the empty outputs and reports the launch to the
dry-run (``cost.report``).  b and c are read
through their strides, so one group broadcast to every head is an
``expand``ed view with a head stride of 0 and is never copied.  bf16
runs the tensor-core kernel, whose blocks each walk ``ssd_plan``'s
number of consecutive heads of one chunk; fp32 the CUDA-core kernel, one
head a block.  Q <= 128, P <= 64 and N <= 128 on either device (Zamba2's
N = 64 and Mamba2-2.7B's N = 128; the kernels take N as 64 or 128
columns).  Forward only, as the reference kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fcnn_layer import KernelLimitError, device_type
from repro_torch.kernels.flash_attention import check_float_args

__all__ = ["ssd_chunk", "ssd_plan"]

MAX_CHUNK = 128
MAX_P = 64      # head dim: one 64-column tile
MAX_N = 128     # state size: one or two 64-column tiles

# csrc/ssd_scan.cu, bf16: a block walks up to 8 heads of a chunk.  Where
# N <= 64 (101 KB of shared memory a block) two blocks share an SM of the
# H100's 132, and the plan keeps the grid at three in four of those 264
# slots or more.  Where N > 64 (165 KB) an SM holds one block, so nothing
# overlaps a block's serial phases but the next wave: the plan keeps four
# waves (chip_smoke.py phase 7 sweeps the choices; at mamba2-2.7b's 16
# chunks x 80 heads, 2 heads a block ran fastest, 8 slowest)
SSD_HEADS = (8, 4, 2, 1)
SM_COUNT = 132


def ssd_min_blocks(n: int) -> int:
    """The fewest blocks a plan leaves at state size ``n``."""
    return 3 * 2 * SM_COUNT // 4 if n <= 64 else 4 * SM_COUNT


SSD_MIN_BLOCKS = ssd_min_blocks(64)


def ssd_plan(bc: int, h: int, q: int, shared_bc: bool, n: int = 64) -> int:
    """Heads a block of the bf16 kernel walks for ``bc`` chunks of ``q``
    rows, ``h`` heads and state size ``n``.  Where B and C are one group
    broadcast to every head (``shared_bc``), the block stages them once for
    all its heads: the largest of SSD_HEADS that divides ``h`` and leaves
    at least ``ssd_min_blocks(n)`` blocks.  Per-head B and C are staged per
    head anyway, so walking heads gains nothing there: 1."""
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"ssd_plan: chunk {q} outside 1..{MAX_CHUNK}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"ssd_plan: state size {n} outside 1..{MAX_N}")
    if not shared_bc:
        return 1
    for heads in SSD_HEADS[:-1]:
        if h % heads == 0 and bc * (h // heads) >= ssd_min_blocks(n):
            return heads
    return 1


def ssd_chunk(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (BC, Q, H, P), dt_a (BC, Q, H), b, c (BC, Q, H, N) ->
    (y_diag (BC, Q, H, P) in x's dtype, state (BC, H, P, N) fp32,
    decay (BC, Q, H) fp32)."""
    if x.dim() != 4 or dt_a.dim() != 3 or b.dim() != 4 or c.dim() != 4:
        raise ValueError("ssd_chunk: x, b, c must be 4-D and dt_a 3-D")
    bc, q, h, p = x.shape
    n = b.shape[-1]
    if tuple(dt_a.shape) != (bc, q, h):
        raise ValueError(f"ssd_chunk: dt_a has shape {tuple(dt_a.shape)}, "
                         f"expected {(bc, q, h)}")
    for name, t in (("b", b), ("c", c)):
        if tuple(t.shape) != (bc, q, h, n):
            raise ValueError(f"ssd_chunk: {name} has shape {tuple(t.shape)}, "
                             f"expected {(bc, q, h, n)}")
    if (min(bc, q, h, p, n) < 1 or bc > 65535 or q > MAX_CHUNK
            or p > MAX_P or n > MAX_N):
        error = ValueError if min(bc, q, h, p, n) < 1 else KernelLimitError
        raise error(f"ssd_chunk: x {tuple(x.shape)}, N = {n} outside "
                    f"BC <= 65535, Q <= {MAX_CHUNK}, P <= {MAX_P}, "
                    f"N <= {MAX_N}")
    check_float_args("ssd_chunk", x=x, b=b, c=c)
    if dt_a.dtype != torch.float32:
        raise TypeError(f"ssd_chunk: dt_a must be float32, got {dt_a.dtype}")
    dev = device_type("ssd_chunk", x, dt_a, b, c)
    if dev == "cpu":
        return _ref.ssd_chunk_ref(x, dt_a, b, c)
    y = torch.empty((bc, q, h, p), device=x.device, dtype=x.dtype)
    state = torch.empty((bc, h, p, n), device=x.device, dtype=torch.float32)
    decay = torch.empty((bc, q, h), device=x.device, dtype=torch.float32)
    shared_bc = b.stride(2) == 0 and c.stride(2) == 0
    if dev == "meta":
        cost.report("ssd_chunk", cost.ssd_chunk(
            bc, q, h, p, n, 1 if shared_bc else h, x.element_size()))
        return y, state, decay
    heads = ssd_plan(bc, h, q, shared_bc, n) if x.dtype == torch.bfloat16 \
        else 1
    _build.extension().ssd_chunk(x, dt_a, b, c, y, state, decay, heads)
    ssd_chunk.launches += 1
    return y, state, decay


ssd_chunk.launches = 0
