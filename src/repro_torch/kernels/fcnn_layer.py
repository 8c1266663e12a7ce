"""Wrappers of the three FCNN period kernels.

  fcnn_layer        act(x @ w + b)                 replaces repro/kernels/fcnn_layer.py:142
  fcnn_layer_dgrad  dX = (dY ⊙ A'(Y)) @ Wᵀ         replaces repro/kernels/fcnn_layer.py:208
  fcnn_layer_wgrad  (Xᵀ @ dZ, Σ_rows dZ)           replaces repro/kernels/fcnn_layer.py:292

Each has two kernels.  K1 and K2 pick by w's dtype, K3 by x's.  With
bf16 w (cases (a) and (b) below) K1 and K2 multiply on the tensor cores:
``csrc/fcnn_fwd_tc.cu`` and ``csrc/fcnn_dgrad_tc.cu`` (wgmma; an fp32
operand, K1's x in (b) and K2's dZ always, split into bf16 hi + lo and
multiplied twice), with the tile width and cluster split that
``fwd_tc_plan`` and ``dgrad_tc_plan`` pick from the shape.  With fp32 w
(cases (c) and (d)) they multiply in fp32 on the CUDA cores:
``csrc/fcnn_fwd.cu`` and ``csrc/fcnn_dgrad.cu``, with the (split, slice)
of ``fwd_plan`` and ``dgrad_plan`` (one rule, ``splitk_plan``).  Every
kernel splits its contraction over the blocks of a thread-block cluster.
K3's contraction is the batch.  With bf16 x (cases (a) and (d)) it runs
``csrc/fcnn_wgrad_tc.cu`` on the tensor cores (dWᵀ = dZᵀ·X, dZ split hi +
lo; ``wgrad_tc_plan``), with fp32 x (cases (b), (c)) ``csrc/fcnn_wgrad.cu``
in fp32 on the CUDA cores (``wgrad_plan`` picks its dW tile).  K2 at a
contraction of at most ``TC_NARROW`` (the output layers' 10) stays on the
CUDA cores whatever the dtypes (``TC_NARROW`` says why).  The rule is
``cost.uses_tc``, which the wrappers dispatch by and ``kernels/cost.py``
counts by.

Each wrapper checks dtype, shape and contiguity, then picks by the
tensors' device: on CUDA it allocates the outputs, launches the kernel on
the current stream and adds one to its ``launches`` counter (the
tensor-core kernels of K1-K3 also to ``tc_launches``); on the CPU it
runs the plain version from ``ref.py``; on the meta device (the dry-run)
it returns the empty outputs and reports the launch and its ``cost`` to
the active recorders (``cost.report``), leaving ``launches`` to the card.
There is no other path: a CUDA tensor never reaches the plain version,
and a failed build or launch raises.  A size beyond what a kernel indexes
raises ``KernelLimitError`` on every device.

Dtypes follow the reference's kernels.  Each operand group is fp32 or
bf16 on its own: K1's x, and its (w, b); K2's (dy, y), and its w; K3's x,
and its (dy, y).  The outputs take the reference's dtypes: K1's y x's,
K2's dX dy's, K3's dW x's and db dy's.  The kernels read every operand in
its own dtype (no wrapper upcasts one), accumulate in fp32 and round a
bf16 output once.  The four (x, w) cases the FCNN reaches, and the
kernels each reaches:
  (a) bf16 data in a bf16 network: K1, K2 and K3 on the tensor cores (K1
      one bf16 product, exact in fp32; K2's and K3's fp32 dZ split hi/lo);
  (b) fp32 data in a bf16 network (every layer's activations fp32
      against bf16 weights): K1 and K2 on the tensor cores (x and dZ
      split hi/lo), K3 in fp32 on the CUDA cores;
  (c) fp32 throughout: K1, K2 and K3 in fp32 on the CUDA cores;
  (d) bf16 data in an fp32 network: K1 and K2 in fp32 on the CUDA cores,
      K3 on the tensor cores (dZ split hi/lo);
and in every case K2 of the output layer (N = 10 <= TC_NARROW) on the
CUDA cores.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels import ref as _ref

__all__ = ["fcnn_layer", "fcnn_layer_dgrad", "fcnn_layer_wgrad",
           "fwd_plan", "dgrad_plan", "wgrad_plan", "splitk_plan",
           "fwd_tc_plan", "dgrad_tc_plan", "wgrad_tc_plan", "fwd_tc_smem",
           "dgrad_tc_smem", "wgrad_tc_smem", "TC_NARROW", "KernelLimitError"]

# codes of csrc/fcnn_act.cuh's Act enum
ACT_CODES = {"none": 0, "sigmoid": 1, "relu": 2, "tanh": 3}

_INT32_MAX = 2**31 - 1


class KernelLimitError(ValueError):
    """A size beyond what a kernel indexes or tiles (its elements past
    2**31 - 1, a head dimension past 128, ...), refused on every device."""

# csrc/fcnn_fwd.cu and csrc/fcnn_dgrad.cu: output tiles of 64 x 32 and
# 128 threads, contraction slices of 16 or 32, clusters of up to 16 blocks
# (above 8, the non-portable size).  Each kernel's limits, as chip_smoke.py
# phase 3's sweep of (split, slice) chose them on the H100 (132 SMs): the
# largest split; how many blocks the grid may hold (four to an SM for K1,
# whose 41.5 KB ring leaves room for them; two for K2, whose 69 KB ring
# ran slower at three); the fewest contraction slices a block may get.
# A bf16 operand keeps the tiles and the plans: it halves its part of the
# ring, which only leaves more room for the blocks the limits allow.
SPLITK_TILE = (64, 32)
FWD_LIMITS = (16, 4 * 132, 1)
DGRAD_LIMITS = (8, 2 * 132, 2)


def _split(tiles: int, slices: int, limits: tuple[int, int, int]) -> int:
    """The largest power-of-two split of ``slices`` contraction slices
    over the blocks of a cluster, for ``tiles`` output tiles, within
    ``limits = (largest split, block slots, least slices a block)``."""
    max_split, block_slots, min_slices = limits
    split = 1
    while (split < max_split and tiles * split * 2 <= block_slots
           and slices >= split * 2 * min_slices):
        split *= 2
    return split


def splitk_plan(tiles: int, contraction: int,
                limits: tuple[int, int, int]) -> tuple[int, int]:
    """(split, slice) of a cluster split-K kernel with ``tiles`` output
    tiles over ``contraction``: slices of 32 where the contraction is >= 64,
    else 16; the split as ``_split`` picks it."""
    slice_ = 32 if contraction >= 64 else 16
    return _split(tiles, -(-contraction // slice_), limits), slice_


def _tiles(rows: int, cols: int) -> int:
    return -(-rows // SPLITK_TILE[0]) * -(-cols // SPLITK_TILE[1])


def fwd_plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(split, slice) of K1 for out (m, n) over the contraction k."""
    return splitk_plan(_tiles(m, n), k, FWD_LIMITS)


def dgrad_plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(split, slice) of K2 for dX (m, k) over the contraction n."""
    return splitk_plan(_tiles(m, k), n, DGRAD_LIMITS)


# csrc/fcnn_fwd_tc.cu and csrc/fcnn_dgrad_tc.cu (bf16 w): one warpgroup a
# block, output tiles of 64 rows and a width (K1: 16 or 64; K2: 64 or
# 128), contraction slices of 64 in a ring of 3 to 8 stages, clusters of
# up to 16.  The plans, as chip_smoke.py phase 23's sweep of (width,
# split) chose them on the H100 (132 SMs): a grid of at most one block an
# SM (where a second block an SM came from a larger split, the cluster's
# sum cost more than the second block hid) and any split up to 16 that
# leaves every block a slice; K1 at width 64, 16 where N <= 16 (the output
# layers' 10); K2 at the widest width whose grid fills three in four of
# the slots, else 64 (a 128-wide dX tile reads dY and Y half as often for
# each byte of W).
TC_ROWS = 64
TC_SLICE = 64
FWD_TC_WIDTHS = (16, 64)
DGRAD_TC_WIDTHS = (64, 128)
TC_LIMITS = (16, 132, 1)
TC_MIN_BLOCKS = 3 * 132 // 4
# csrc/fcnn_wgrad_tc.cu (bf16 x): dWᵀ tiles of 64 columns of dW by a width
# of rows, the batch split over a cluster in slices of 64.  The plan takes
# width 64 where its grid fits two blocks an SM (at a batch of 64 or 128 a
# launch takes one or two stages of its ring, at width 64 at most 87 KB,
# with fp32 dY: room for two): each block's work is one or two slices, so
# more blocks hide more of each one's load latency; past two blocks an SM,
# width 128's blocks, which read each batch row of dY and Y half as often,
# run faster.  The split is 2 only where the grid leaves half the SMs idle
# (NN5's output layer, 63 tiles).  chip_smoke.py
# phase 23's sweep on the H100, case (a), ms: NN1 L1 (64 x 784 x 1000)
# 64/1 0.00425, 128/1 0.00443; NN1 L2 64/1 0.00619, 128/1 0.00861; NN5
# L1-L3 128/1 0.01227-0.01350, 64/1 0.01550-0.01653; NN5 L4 (N = 10) 64/2
# 0.00733, 64/1 0.00855; every split of 2 or 4 slower elsewhere.  At N =
# 10 the CUDA-core kernel's best tile ran 0.00657 (NN1 L3, against 64/1's
# 0.00590) and 0.01025 (NN5 L4): K3 takes no narrow rule.
WGRAD_TC_WIDTHS = (64, 128)
WGRAD_TC_SLOTS = 2 * 132
# K2's contraction N at or below which a bf16-w call stays on the CUDA
# cores (fcnn_dgrad.cu): the tensor-core kernel's slices of 64 contraction
# elements hold 10 at the output layers.  chip_smoke.py phase 23's sweep on
# the H100 measured K2 at NN1 L3 (64 x 500 x 10) 0.00243 ms on the CUDA
# cores against 0.00409 on the tensor cores, at NN5 L4 (128 x 4000 x 10)
# 0.00350 against 0.00459.  kernels/cost.py counts the products by the same
# rule.  K3 takes no such rule: its tensor-core kernel tiles N = 10 with 64
# wgmma rows, 54 of them idle, and still ran faster than the CUDA-core one
# (the note above WGRAD_TC_WIDTHS).
TC_NARROW = cost.TC_NARROW


def _ring_bytes(stage: int) -> int:
    """A ring of ``stage``-byte stages and its 1024 bytes of alignment, as
    deep as ``fcnn_tc::ring_stages`` (csrc/fcnn_tc.cuh) makes it: as many
    stages as fit in 110 KB, at least 3 and at most 8."""
    return min(max(110 * 1024 // stage, 3), 8) * stage + 1024


def fwd_tc_smem(x_size: int, width: int) -> int:
    """Dynamic shared memory of K1's tensor-core kernel (``Layout`` in
    csrc/fcnn_fwd_tc.cu): per stage x's slice (a swizzled bf16 tile of 64
    x 64, or 64 padded fp32 rows of 72) and w's (64 rows of ``width``
    columns)."""
    x_tile = TC_ROWS * (128 if x_size == 2 else (TC_SLICE + 8) * 4)
    w_tile = TC_SLICE * (32 if width == 16 else 128)
    return _ring_bytes(x_tile + w_tile)


def dgrad_tc_smem(dy_size: int, width: int) -> int:
    """Dynamic shared memory of K2's tensor-core kernel (``Layout`` in
    csrc/fcnn_dgrad_tc.cu): per stage dY's and Y's slices (64 padded rows
    of 72 in dy's type) and Wᵀ's (``width`` rows of 64 bf16)."""
    return _ring_bytes(2 * TC_ROWS * (TC_SLICE + 8) * dy_size + width * 128)


def wgrad_tc_smem(dy_size: int, width: int, m: int | None = None,
                  split: int = 1) -> int:
    """Dynamic shared memory of K3's tensor-core kernel (``Layout`` and
    ``launch`` in csrc/fcnn_wgrad_tc.cu): per stage X's slice (64 batch rows
    of ``width`` bf16) and dY's and Y's (64 batch rows of 64 columns, padded
    to 68 fp32 or 72 bf16); the whole ring where ``m`` is None, else the
    stages a launch over a batch ``m`` split ``split`` ways takes: a rank's
    slices, and no fewer than the epilogue's partials and dW tile need."""
    pitch = TC_ROWS + (4 if dy_size == 4 else 8)
    stage = TC_SLICE * width * 2 + 2 * TC_SLICE * pitch * dy_size
    ring = _ring_bytes(stage)
    if m is None:
        return ring
    epilogue = TC_ROWS * (width + 8) * 4 + width * (TC_ROWS + 8) * 2
    stages = max(-(-(-(-m // TC_SLICE)) // split), -(-epilogue // stage))
    return min(stages * stage + 1024, ring)


def fwd_tc_plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(width, split) of K1's tensor-core kernel for out (m, n) over the
    contraction k."""
    width = 16 if n <= 16 else 64
    tiles = -(-m // TC_ROWS) * -(-n // width)
    return width, _split(tiles, -(-k // TC_SLICE), TC_LIMITS)


def dgrad_tc_plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(width, split) of K2's tensor-core kernel for dX (m, k) over the
    contraction n: width 128 where its grid holds TC_MIN_BLOCKS blocks,
    else 64."""
    slices = -(-n // TC_SLICE)
    for width in (128, 64):
        tiles = -(-m // TC_ROWS) * -(-k // width)
        split = _split(tiles, slices, TC_LIMITS)
        if tiles * split >= TC_MIN_BLOCKS:
            break
    return width, split


def wgrad_tc_plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(width, split) of K3's tensor-core kernel for dWᵀ (n, k) over the
    batch m: tiles of 64 columns of dW by ``width`` rows, width 64 where
    its grid fits WGRAD_TC_SLOTS, else 128; the batch split over ``split``
    blocks of a cluster as ``_split`` picks it."""
    cols = -(-n // TC_ROWS)
    width = 64 if cols * -(-k // 64) <= WGRAD_TC_SLOTS else 128
    return width, _split(cols * -(-k // width), -(-m // TC_SLICE), TC_LIMITS)


# csrc/fcnn_wgrad.cu: dW tiles (rows, columns), the largest first; a tile
# is taken where its grid keeps at least three in four of the H100's 132
# SMs busy (chip_smoke.py phase 3's sweep of the three); bf16 operands take
# the same tiles
WGRAD_TILES = ((128, 128), (128, 64), (64, 64))
WGRAD_MIN_BLOCKS = 3 * 132 // 4


def wgrad_plan(k: int, n: int) -> tuple[int, int]:
    """K3's dW tile for dW (k, n): the largest of WGRAD_TILES whose grid
    holds at least WGRAD_MIN_BLOCKS blocks (a larger tile's blocks read
    each batch row of x, dY and Y fewer times), else the smallest."""
    for rows, cols in WGRAD_TILES[:-1]:
        if -(-k // rows) * -(-n // cols) >= WGRAD_MIN_BLOCKS:
            return rows, cols
    return WGRAD_TILES[-1]


def act_code(activation: str) -> int:
    try:
        return ACT_CODES[activation]
    except KeyError:
        raise ValueError(f"unknown activation {activation!r}") from None


def device_type(kernel: str, *tensors: torch.Tensor) -> str:
    """``"cuda"``, ``"cpu"`` or ``"meta"``: where a kernel call's tensors
    all lie."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: tensors lie on several devices "
                         f"{sorted(str(d) for d in devices)}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{kernel}: unsupported device {dev}")
    return dev.type


FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def check_arg(kernel: str, name: str, t: torch.Tensor, shape: tuple,
              dtype: torch.dtype | tuple[torch.dtype, ...] = torch.float32
              ) -> None:
    """Raise unless ``t`` has this shape and dtype (one of them, for a
    tuple) and is contiguous, with every size in 1..2**31-1 (the kernels
    index with 32-bit ints)."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} must be "
                        f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if t.numel() == 0 or t.numel() > _INT32_MAX:
        error = KernelLimitError if t.numel() else ValueError
        raise error(f"{kernel}: {name} has {t.numel()} elements; "
                    f"1..{_INT32_MAX} supported")


def _matrix(kernel: str, name: str, t: torch.Tensor) -> tuple[int, int]:
    if t.dim() != 2:
        raise ValueError(f"{kernel}: {name} must be 2-D, got {t.dim()}-D")
    return t.shape[0], t.shape[1]


def fcnn_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               activation: str = "sigmoid") -> torch.Tensor:
    """act(x @ w + b).  x: (M, K); w: (K, N); b: (N,) in w's dtype -> (M,
    N) in x's dtype."""
    act = act_code(activation)
    m, k = _matrix("fcnn_layer", "x", x)
    n = _matrix("fcnn_layer", "w", w)[1]
    check_arg("fcnn_layer", "x", x, (m, k), FLOAT_DTYPES)
    check_arg("fcnn_layer", "w", w, (k, n), FLOAT_DTYPES)
    check_arg("fcnn_layer", "b", b, (n,), w.dtype)
    dev = device_type("fcnn_layer", x, w, b)
    if dev == "cpu":
        return _ref.fcnn_layer_ref(x, w, b, activation)
    out = torch.empty((m, n), device=x.device, dtype=x.dtype)
    if dev == "meta":
        cost.report("fcnn_layer", cost.fcnn_fwd(m, k, n, x.element_size(),
                                                w.element_size()))
        return out
    if cost.uses_tc("fcnn_layer", w_size=w.element_size()):
        _build.extension().fcnn_fwd_tc(x, w, b, out, act, *fwd_tc_plan(m, k, n))
        fcnn_layer.tc_launches += 1
    else:
        _build.extension().fcnn_fwd(x, w, b, out, act, *fwd_plan(m, k, n))
    fcnn_layer.launches += 1
    return out


def fcnn_layer_dgrad(dy: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                     activation: str = "sigmoid") -> torch.Tensor:
    """dX = (dY ⊙ A'(Y)) @ Wᵀ.  dy, y: (M, N), y in dy's dtype; w: (K, N)
    -> (M, K) in dy's dtype."""
    act = act_code(activation)
    m, n = _matrix("fcnn_layer_dgrad", "dy", dy)
    k = _matrix("fcnn_layer_dgrad", "w", w)[0]
    check_arg("fcnn_layer_dgrad", "dy", dy, (m, n), FLOAT_DTYPES)
    check_arg("fcnn_layer_dgrad", "y", y, (m, n), dy.dtype)
    check_arg("fcnn_layer_dgrad", "w", w, (k, n), FLOAT_DTYPES)
    dev = device_type("fcnn_layer_dgrad", dy, y, w)
    if dev == "cpu":
        return _ref.fcnn_layer_dgrad_ref(dy, y, w, activation)
    dx = torch.empty((m, k), device=dy.device, dtype=dy.dtype)
    if dev == "meta":
        cost.report("fcnn_layer_dgrad", cost.fcnn_dgrad(
            m, k, n, dy.element_size(), w.element_size()))
        return dx
    if cost.uses_tc("fcnn_layer_dgrad", w_size=w.element_size(), n=n):
        _build.extension().fcnn_dgrad_tc(dy, y, w, dx, act,
                                         *dgrad_tc_plan(m, k, n))
        fcnn_layer_dgrad.tc_launches += 1
    else:
        _build.extension().fcnn_dgrad(dy, y, w, dx, act,
                                      *dgrad_plan(m, k, n))
    fcnn_layer_dgrad.launches += 1
    return dx


def fcnn_layer_wgrad(x: torch.Tensor, dy: torch.Tensor, y: torch.Tensor,
                     activation: str = "sigmoid"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dW, db) = (Xᵀ @ dZ, Σ_rows dZ) with dZ = dY ⊙ A'(Y).
    x: (M, K); dy, y: (M, N), y in dy's dtype -> ((K, N) in x's dtype, (N,)
    in dy's)."""
    act = act_code(activation)
    m, k = _matrix("fcnn_layer_wgrad", "x", x)
    n = _matrix("fcnn_layer_wgrad", "dy", dy)[1]
    check_arg("fcnn_layer_wgrad", "x", x, (m, k), FLOAT_DTYPES)
    check_arg("fcnn_layer_wgrad", "dy", dy, (m, n), FLOAT_DTYPES)
    check_arg("fcnn_layer_wgrad", "y", y, (m, n), dy.dtype)
    dev = device_type("fcnn_layer_wgrad", x, dy, y)
    if dev == "cpu":
        return _ref.fcnn_layer_wgrad_ref(x, dy, y, activation)
    dw = torch.empty((k, n), device=x.device, dtype=x.dtype)
    db = torch.empty((n,), device=x.device, dtype=dy.dtype)
    if dev == "meta":
        cost.report("fcnn_layer_wgrad", cost.fcnn_wgrad(
            m, k, n, x.element_size(), dy.element_size()))
        return dw, db
    if cost.uses_tc("fcnn_layer_wgrad", x_size=x.element_size()):
        _build.extension().fcnn_wgrad_tc(x, dy, y, dw, db, act,
                                         *wgrad_tc_plan(m, k, n))
        fcnn_layer_wgrad.tc_launches += 1
    else:
        _build.extension().fcnn_wgrad(x, dy, y, dw, db, act,
                                      *wgrad_plan(k, n))
    fcnn_layer_wgrad.launches += 1
    return dw, db


fcnn_layer.launches = 0
fcnn_layer_dgrad.launches = 0
fcnn_layer_wgrad.launches = 0
# the launches of the tensor-core kernels alone, also in ``launches``
fcnn_layer.tc_launches = 0
fcnn_layer_dgrad.tc_launches = 0
fcnn_layer_wgrad.tc_launches = 0
