"""Wrappers of the Mamba2 SSD intra-chunk kernel (``csrc/ssd_scan.cu``)
and of its backward (``csrc/ssd_scan_bwd.cu``), which the Mamba2 and
Zamba2 training steps run.

  ssd_chunk      (y_diag, chunk state, exp(cumsum dt_a)) per chunk   replaces repro/kernels/ssd_scan.py:60
  ssd_chunk_bwd  dx, d(dt_a), dB, dC from the three cotangents      counterpart of jax.vjp of repro/kernels/ref.py:122

``ssd_chunk`` checks device, dtype (x, b and c fp32 or bf16, of one
dtype; dt_a fp32), shapes and strides, then picks by the tensors'
device: on CUDA it allocates the three outputs, launches the kernel on
the current stream (all chunks and heads in one launch) and adds one to
``launches``; on the CPU it runs the plain version from ``ref.py``; on
the meta device it returns the empty outputs and reports the launch to
the dry-run (``cost.report``).  b and c are read through their strides,
so one group broadcast to every head is an ``expand``ed view with a head
stride of 0 and is never copied.  bf16 runs the wgmma kernel, whose
blocks each walk ``ssd_plan``'s number of consecutive heads of one chunk;
fp32 the 3xTF32 kernel on mma.sync, whose blocks walk ``ssd_bwd_plan``'s
heads of one B/C group, as the backward's do: where B and C are one
group broadcast to every head (one head a block where they are per
head).  Q <= 128, P <= 64 and N <=
128 on either device (Zamba2's N = 64 and Mamba2-2.7B's N = 128; the
kernels take N as 64 or 128 columns).  The raw wrapper refuses inputs
that require grad: ``ops.ssd_chunk`` is the differentiable op, an
autograd function whose backward calls ``ssd_chunk_bwd``.

``ssd_chunk_bwd`` takes the forward's checks and inputs, the cotangents
dy (x's shape and dtype), dstate (BC, H, P, N) fp32 and ddecay (BC, Q, H)
fp32, any of them None (zero), and ``groups``: B and C hold ``groups``
distinct groups of H / groups consecutive heads (the model's
``ssm_groups``; None: one a head), and dB and dC come back summed over
each group, (BC, Q, groups, N).  It picks by device as the forward does:
CPU, the plain ``ref.ssd_chunk_bwd_ref``; meta, empty gradients, the
scratch the card would take and ``cost.ssd_chunk_bwd``; CUDA, the kernels
of ``ssd_scan_bwd.cu`` with one count in ``ssd_chunk_bwd.launches``.  In
either dtype a block walks ``ssd_bwd_plan``'s number of consecutive heads
of one group (bf16 on wgmma, fp32 as 3xTF32 on mma.sync): it sums their
dS and w∘(x·dst) in fp32, takes dB's and dC's products over the sum once,
and writes one fp32 part of its group (no scratch at all where a block is
a whole group), which a second kernel adds in block order and rounds
once.  No atomics: repeats are bit-identical.  The gradients leave in
x's, dt_a's (fp32), b's and c's dtypes, contiguous.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fcnn_layer import KernelLimitError, device_type
from repro_torch.kernels.flash_attention import check_float_args

__all__ = ["ssd_chunk", "ssd_chunk_bwd", "ssd_plan", "ssd_bwd_plan"]

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


# csrc/ssd_scan_bwd.cu: a block walks up to 16 heads of one B/C group
# (bf16: 227 KB of shared memory and up to 246 registers a thread; fp32:
# 216,576-219,648 bytes; one block an SM either way), and so does the fp32
# forward's in csrc/ssd_scan.cu (157,696 bytes at N <= 64, 221,184 at N =
# 128), which takes the same plan: its sweep in phase 7 found the plan
# fastest at every timed shape.  Its fixed work (B and C
# staged, S, the dB and dC products over ΣdS, the part written) is taken
# as SSD_BWD_BLOCK_COST heads' worth; the plan takes the heads that
# minimise waves x (heads + that cost) on the H100's 132 SMs, the fewer
# heads on a tie.  chip_smoke.py phase 7 sweeps the choices at both
# training shapes: the plan's 8 of Zamba2-1.2B's 64 heads and 10 of
# mamba2-2.7b's 80 ran fastest in bf16 (8 of 80 leave a second wave of 28
# blocks).
SSD_BWD_HEADS = (1, 2, 4, 5, 8, 10, 16)
SSD_BWD_BLOCK_COST = 1.5


def ssd_bwd_plan(bc: int, h: int, q: int, groups: int, n: int = 64) -> int:
    """Heads a block of the backward walks for ``bc`` chunks of ``q``
    rows, ``h`` heads in ``groups`` B/C groups and state size ``n``: a
    divisor of ``h // groups`` from SSD_BWD_HEADS (a block's heads share
    one group's B and C).  Per-head B and C (``groups == h``) give 1."""
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"ssd_bwd_plan: chunk {q} outside 1..{MAX_CHUNK}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"ssd_bwd_plan: state size {n} outside 1..{MAX_N}")
    if groups < 1 or h % groups:
        raise ValueError(f"ssd_bwd_plan: {groups} groups do not divide {h} "
                         f"heads")
    per = h // groups

    def span(heads: int) -> float:
        waves = -(-bc * (h // heads) // SM_COUNT)
        return waves * (heads + SSD_BWD_BLOCK_COST)

    return min((k for k in SSD_BWD_HEADS if per % k == 0), key=span)


def bwd_parts_shape(bc: int, q: int, h: int, n: int, groups: int,
                    heads: int) -> tuple[int, ...]:
    """The fp32 scratch ``ssd_chunk_bwd`` takes on the card, in either
    dtype: each block's dB and dC (``h // heads`` blocks a chunk) before
    the group sum; none where a block is a whole group."""
    parts = h // heads
    return (0,) if parts == groups else (2, bc, q, parts, n)


def _check(kernel: str, x: torch.Tensor, dt_a: torch.Tensor,
           b: torch.Tensor, c: torch.Tensor) -> tuple[int, ...]:
    """Raise unless x (BC, Q, H, P), dt_a (BC, Q, H) fp32 and b, c (BC, Q,
    H, N) are shapes the kernels take; return (BC, Q, H, P, N)."""
    if x.dim() != 4 or dt_a.dim() != 3 or b.dim() != 4 or c.dim() != 4:
        raise ValueError(f"{kernel}: x, b, c must be 4-D and dt_a 3-D")
    bc, q, h, p = x.shape
    n = b.shape[-1]
    if tuple(dt_a.shape) != (bc, q, h):
        raise ValueError(f"{kernel}: dt_a has shape {tuple(dt_a.shape)}, "
                         f"expected {(bc, q, h)}")
    for name, t in (("b", b), ("c", c)):
        if tuple(t.shape) != (bc, q, h, n):
            raise ValueError(f"{kernel}: {name} has shape "
                             f"{tuple(t.shape)}, expected {(bc, q, h, n)}")
    if (min(bc, q, h, p, n) < 1 or bc > 65535 or q > MAX_CHUNK
            or p > MAX_P or n > MAX_N):
        error = ValueError if min(bc, q, h, p, n) < 1 else KernelLimitError
        raise error(f"{kernel}: x {tuple(x.shape)}, N = {n} outside "
                    f"BC <= 65535, Q <= {MAX_CHUNK}, P <= {MAX_P}, "
                    f"N <= {MAX_N}")
    if dt_a.dtype != torch.float32:
        raise TypeError(f"{kernel}: dt_a must be float32, got {dt_a.dtype}")
    return bc, q, h, p, n


def ssd_chunk(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (BC, Q, H, P), dt_a (BC, Q, H), b, c (BC, Q, H, N) ->
    (y_diag (BC, Q, H, P) in x's dtype, state (BC, H, P, N) fp32,
    decay (BC, Q, H) fp32)."""
    bc, q, h, p, n = _check("ssd_chunk", x, dt_a, b, c)
    check_float_args("ssd_chunk", x=x, b=b, c=c)
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
    heads = (ssd_plan(bc, h, q, shared_bc, n) if x.dtype == torch.bfloat16
             else ssd_bwd_plan(bc, h, q, 1 if shared_bc else h, n))
    _build.extension().ssd_chunk(x, dt_a, b, c, y, state, decay, heads)
    ssd_chunk.launches += 1
    return y, state, decay


ssd_chunk.launches = 0


def ssd_chunk_bwd(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, dy: torch.Tensor | None,
                  dstate: torch.Tensor | None, ddecay: torch.Tensor | None,
                  groups: int | None = None, *, heads: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """(dx, d(dt_a), db, dc) of ``ssd_chunk(x, dt_a, b, c)`` for the
    cotangents of its three outputs (None: zero); db and dc (BC, Q, G, N)
    summed over each of ``groups`` = G groups of consecutive heads.
    ``heads``: the kernel's heads a block (a divisor of H / G of
    SSD_BWD_HEADS; None: ``ssd_bwd_plan``'s)."""
    kernel = "ssd_chunk_bwd"
    bc, q, h, p, n = _check(kernel, x, dt_a, b, c)
    g = h if groups is None else int(groups)
    if g < 1 or h % g:
        raise ValueError(f"{kernel}: {g} groups do not divide {h} heads")
    if dy is not None and tuple(dy.shape) != (bc, q, h, p):
        raise ValueError(f"{kernel}: dy has shape {tuple(dy.shape)}, "
                         f"expected x's {(bc, q, h, p)}")
    for name, t, shape in (("dstate", dstate, (bc, h, p, n)),
                           ("ddecay", ddecay, (bc, q, h))):
        if t is not None and (tuple(t.shape) != shape
                              or t.dtype != torch.float32):
            raise ValueError(f"{kernel}: {name} must be {shape} float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    given = {"dy": dy} if dy is not None else {}
    check_float_args(kernel, x=x, b=b, c=c, **given)
    cots = [t for t in (dy, dstate, ddecay) if t is not None]
    dev = device_type(kernel, x, dt_a, b, c, *cots)
    if dev == "cpu":
        return _ref.ssd_chunk_bwd_ref(x, dt_a, b, c, dy, dstate, ddecay, g)
    dx = torch.empty((bc, q, h, p), device=x.device, dtype=x.dtype)
    ddt = torch.empty((bc, q, h), device=x.device, dtype=torch.float32)
    db = torch.empty((bc, q, g, n), device=x.device, dtype=b.dtype)
    dc = torch.empty((bc, q, g, n), device=x.device, dtype=c.dtype)
    if heads is None:
        heads = ssd_bwd_plan(bc, h, q, g, n)
    elif heads not in SSD_BWD_HEADS or (h // g) % heads:
        raise ValueError(f"{kernel}: {heads} heads a block: not one of "
                         f"{SSD_BWD_HEADS} dividing {h // g}")
    parts = torch.empty(bwd_parts_shape(bc, q, h, n, g, heads),
                        device=x.device, dtype=torch.float32)
    if dev == "meta":
        cost.report(kernel, cost.ssd_chunk_bwd(bc, q, h, p, n, g,
                                               x.element_size()))
        return dx, ddt, db, dc
    none = torch.empty(0, device=x.device)
    _build.extension().ssd_chunk_bwd(
        x, dt_a, b, c, none if dy is None else dy,
        none if dstate is None else dstate.contiguous(),
        none if ddecay is None else ddecay.contiguous(),
        dx, ddt, parts, db, dc, heads)
    ssd_chunk_bwd.launches += 1
    return dx, ddt, db, dc


ssd_chunk_bwd.launches = 0
