"""Wrappers of the flash-attention kernel (``csrc/flash_attention.cu``),
the LM's self- and cross-attention, and of its backward
(``csrc/flash_attention_bwd.cu``), which the LM training step runs.

  flash_attention      softmax(q kᵀ/√D, causal or not) v, and with
                       ``lse=True`` each row's log-sum-exp      replaces repro/kernels/flash_attention.py:72
  flash_attention_bwd  dq, dk, dv from q, k, v, o, dO and lse   counterpart of _sdpa_chunked_bwd (repro/models/layers.py)

A causal call may take a sliding window: ``window`` > 0 keeps key k for
query q where q - window < k <= q, the reference model's mask for a
prefill longer than ``attn_window`` (``repro/models/layers.py``
``attention``); the kernel skips the key tiles below the window, so a
windowed prefill costs O(S·window).  0 is no window.

q is (B, H, Sq, D) and k, v are (B, KV, Sk, D) with H a multiple of KV:
grouped-query attention, query head h reading KV head h // (H // KV), as
the model's ``_sdpa`` groups them (KV = H is multi-head attention).  The
kernel indexes the KV head itself, so K and V are never repeated or
copied per group.  Keys of another length than the queries are
cross-attention (the encoder-decoder's decoder over the encoder's
frames), which is not causal: causal attention with Sq != Sk has no
caller in the reference and is refused on either device, the plain
version included (``ref.check_causal_lengths``).  Checks device, dtype (fp32 or bf16, the same for q, k
and v), shapes and strides, then picks by the tensors' device: on CUDA it allocates the
output in q's memory layout, launches the kernel on the current stream
and adds one to ``launches``; on the CPU it runs the plain version from
``ref.py``; on the meta device it returns the empty output and reports
the launch to the dry-run (``cost.report``).  The kernel reads q, k and
v through their (batch, head, seq) strides, so transposed views of the model's (B, S, H, D) projections go
in without a copy.  In bf16 the kernel loads q, k and v with the Tensor
Memory Accelerator, which needs a 16-byte aligned base and (batch, head,
seq) strides of a multiple of 16 bytes: other bf16 views are refused on
either device, before the dispatch, and never rerouted.  The raw
wrapper refuses inputs that require grad rather than silently detaching
them: ``ops.flash_attention`` is the differentiable op, an autograd
function whose forward saves ``lse`` and whose backward calls
``flash_attention_bwd``.

``flash_attention_bwd`` takes the forward's checks, dO of q's shape and
o's too, lse (B, H, Sq) fp32, and picks by device as the forward does:
CPU, the plain ``ref.flash_attention_bwd_ref``; meta, empty gradients,
the same scratch as the card's and ``cost.flash_attention_bwd``; CUDA,
the kernels of ``flash_attention_bwd.cu`` with one count in
``flash_attention_bwd.launches``: three in either dtype, the row stats
with the counters zeroed, one fused kernel for dK, dV and dQ over the unit
list ``bwd_schedule`` builds (bf16: 128-key spans on wgmma; fp32:
64-key spans, every product as 3xTF32 on mma.sync), then dQ's fp32 slots
added (and rounded, in bf16).  The gradients leave in q's, k's and v's
dtypes and memory layouts.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fcnn_layer import KernelLimitError, device_type

__all__ = ["flash_attention", "flash_attention_bwd", "FLOAT_DTYPES",
           "check_float_args", "check_tma_aligned", "tma_aligned",
           "BwdSchedule", "bwd_schedule"]

FLOAT_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
_INT32_MAX = 2**31 - 1


def check_float_args(kernel: str, **tensors: torch.Tensor) -> torch.dtype:
    """Raise unless every tensor is fp32 or bf16 (all of one dtype), has a
    unit last stride and needs no gradient; return the dtype."""
    dtypes = {t.dtype for t in tensors.values()}
    for name, t in tensors.items():
        if t.dtype not in FLOAT_DTYPES:
            raise TypeError(f"{kernel}: {name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dim() and t.stride(-1) != 1 and t.shape[-1] != 1:
            raise ValueError(f"{kernel}: {name} needs a unit stride in its "
                             f"last dimension, got strides {t.stride()}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{kernel} is forward-only (the reference "
                               f"kernel has no VJP); {name} requires grad")
        if t.numel() > _INT32_MAX:
            raise KernelLimitError(f"{kernel}: {name} has {t.numel()} "
                                   f"elements; at most {_INT32_MAX} "
                                   f"supported")
    if len(dtypes) != 1:
        raise TypeError(f"{kernel}: mixed dtypes {sorted(map(str, dtypes))}")
    return dtypes.pop()


def tma_aligned(t: torch.Tensor) -> bool:
    """Whether ``t``'s base address and its strides in every dimension but
    the last (of size > 1) are multiples of 16 bytes (a meta tensor has no
    address: its strides alone count)."""
    e = t.element_size()
    return ((t.is_meta or t.data_ptr() % 16 == 0)
            and all(t.shape[d] == 1 or t.stride(d) * e % 16 == 0
                    for d in range(t.dim() - 1)))


def check_tma_aligned(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise unless each tensor is ``tma_aligned``."""
    for name, t in tensors.items():
        if not tma_aligned(t):
            raise ValueError(
                f"{kernel}: {t.dtype} {name} must be 16-byte aligned, with "
                f"strides of a multiple of 16 bytes (TMA); got address "
                f"{t.data_ptr() % 16} mod 16 and strides {t.stride()}")


def _check_shapes(kernel: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, causal: bool, window: int) -> int:
    """Raise unless q (B, H, Sq, D) and k, v (B, KV, Sk, D) are shapes and a
    mask the kernels take; return ``window`` as an int."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{kernel}: {name} must be (B, H, S, D), "
                             f"got {t.dim()}-D")
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if (k.shape != v.shape or (k.shape[0], k.shape[3]) != (b, d)
            or kv < 1 or h % kv):
        raise ValueError(f"{kernel}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: k and v must "
                         f"be (B, KV, Sk, D) with H % KV == 0 (GQA)")
    if min(b, h, s, sk, d) < 1 or d > MAX_HEAD_DIM or b * h > 65535:
        error = ValueError if min(b, h, s, sk, d) < 1 else KernelLimitError
        raise error(f"{kernel}: q {tuple(q.shape)}, k "
                    f"{tuple(k.shape)} outside B·H <= 65535, Sq, Sk >= 1, "
                    f"1 <= D <= {MAX_HEAD_DIM}")
    window = int(window)
    if window > _INT32_MAX:
        raise KernelLimitError(f"{kernel}: window {window} > {_INT32_MAX}")
    _ref.check_causal_lengths(s, sk, causal, window)
    return window


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, *,
                    lse: bool = False
                    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """q: (B, H, Sq, D), k, v: (B, KV, Sk, D), H % KV == 0, any Sq, Sk >= 1
    (Sk = Sq where causal), D <= 128 -> (B, H, Sq, D) in q's dtype;
    ``window`` >= 0, and > 0 only where causal.  With ``lse`` -> (o, lse),
    lse (B, H, Sq) fp32 the log-sum-exp of each row's scaled scores."""
    window = _check_shapes("flash_attention", q, k, v, causal, window)
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if check_float_args("flash_attention", q=q, k=k, v=v) == torch.bfloat16:
        check_tma_aligned("flash_attention", q=q, k=k, v=v)
    dev = device_type("flash_attention", q, k, v)
    if dev == "cpu":
        if lse:
            return _ref.flash_attention_lse_ref(q, k, v, causal, window)
        return _ref.flash_attention_ref(q, k, v, causal, window)
    out = torch.empty_like(q)
    row_lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
               if lse else None)
    if dev == "meta":
        cost.report("flash_attention", cost.flash_attention(
            b, h, kv, s, sk, d, q.element_size(), causal, window))
    elif lse:
        _build.extension().flash_attention_lse(q, k, v, out, row_lse,
                                               bool(causal), window)
        flash_attention.launches += 1
    else:
        _build.extension().flash_attention(q, k, v, out, bool(causal), window)
        flash_attention.launches += 1
    return (out, row_lse) if lse else out


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, causal: bool = True,
                        window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal, window)`` for the
    cotangent ``dout``, from its output ``o`` and ``lse``: q, o, dout (B,
    H, Sq, D), k, v (B, KV, Sk, D), lse (B, H, Sq) fp32; the gradients in
    q's, k's and v's dtypes and layouts."""
    kernel = "flash_attention_bwd"
    window = _check_shapes(kernel, q, k, v, causal, window)
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("dout", dout)):
        if t.shape != q.shape:
            raise ValueError(f"{kernel}: {name} {tuple(t.shape)} must have "
                             f"q's shape {tuple(q.shape)}")
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"{kernel}: lse must be ({b}, {h}, {s}) float32 "
                         f"and contiguous, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    dtype = check_float_args(kernel, q=q, k=k, v=v, o=o, dout=dout)
    if dtype == torch.bfloat16:
        check_tma_aligned(kernel, q=q, k=k, v=v, dout=dout)
    dev = device_type(kernel, q, k, v, o, dout, lse)
    if dev == "cpu":
        return _ref.flash_attention_bwd_ref(q, k, v, o, dout, lse, causal,
                                            window)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    bf16 = dtype == torch.bfloat16
    sched = bwd_schedule(b, h, kv, s, sk, d, bool(causal), window,
                         BWD_SPAN if bf16 else BWD_F32_SPAN)
    extra = _bwd_scratch(sched, b, h, kv, s, sk, d, q.device, bf16)
    stats = extra.pop(0)
    if dev == "meta":
        cost.report(kernel, cost.flash_attention_bwd(
            b, h, kv, s, sk, d, q.element_size(), causal, window))
    else:
        extra[0] = _plan_tensor(sched, q.device)
        _build.extension().flash_attention_bwd(q, k, v, o, dout, lse, stats,
                                               dq, dk, dv, bool(causal),
                                               window, *extra)
        flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


# ------------------------------------------------------ the unit list

BWD_TILE = 64      # query rows of a walked tile (the kernel's kTile)
BWD_SPAN = 128     # keys of a bf16 unit: 64 for each consumer warpgroup (kSpan)
BWD_F32_SPAN = 64  # keys of an fp32 unit (f32::kSpan): fp32 tiles take
                   # twice the shared memory
BWD_SMS = 132      # the H100's SMs: the persistent grid's blocks at most
# causal walks are cut until the list holds this many units an SM (fewer
# cuts left whole spans' walks, 1.9x an SM's share at granite-3-2b's
# shape, to the last wave; more added units' fixed cost: on the H100
# granite's and qwen3-14b's backward ran fastest cut to 416 units, Zamba2's
# and the window's unsplit at 512 and 1024, tools/k6_bwd_sched.py)
BWD_UNITS_PER_SM = 3
# dQ's fp32 sums: a tile's parts go round-robin into up to this many bytes
# of slots (each its own ordered sum, the slots added when dQ is rounded),
# so a tile's chain of waits is shorter; the rounding kernel reads every
# slot back, which costs more than the waits save once a slot is large
# (tools/k6_bwd_sched.py on the H100: seamless's cross-attention fastest
# at 4 slots of 2 MiB, granite's slower at 2 slots of 16 MiB than at one)
BWD_DQ_BYTES = 8 << 20


class BwdSchedule(NamedTuple):
    """The backward's unit list, one (batch, KV head)'s pattern: units
    ``(span, qt_lo, qt_hi, dkv_rank, dkv_count)`` in list order, span n
    the keys [n·span, (n + 1)·span) (``span`` 128 for the bf16 kernel, 64
    for the fp32 one), walking the query tiles qt_hi - 1 down to
    qt_lo (64 rows each), each with the G heads of the group; dkv_rank of
    dkv_count, the unit's place in its span's dK/dV sum.  ``dq_rank[qt][n]``
    is span n's place among query tile qt's dQ parts (-1: none), and
    ``dq_count[qt]`` their number; part r goes into slot r % ``slots`` of
    the tile's sum, after the parts r - slots, r - 2·slots, ...  The full
    list repeats each pattern unit for the B·KV (batch, KV head)s in turn
    (unit t: pattern unit t // bkv of (batch·KV head) t % bkv); ``tiles``
    is the slice height the walks were cut to, ``blocks`` the persistent
    grid."""
    units: tuple
    dq_rank: tuple
    dq_count: tuple
    bkv: int
    groups: int
    tiles: int
    blocks: int
    slots: int = 1
    span: int = BWD_SPAN

    @property
    def n_units(self) -> int:
        return len(self.units) * self.bkv

    @property
    def split(self) -> bool:
        """Whether a span's walk was cut into slices (dK/dV through scratch)."""
        return any(u[4] > 1 for u in self.units)

    def pairs(self) -> int:
        """(query tile, head) pairs walked over the whole list."""
        return self.bkv * self.groups * sum(u[2] - u[1] for u in self.units)

    def plan(self) -> list[int]:
        """The int32 plan the kernel reads (``Plan`` in the source)."""
        out = []
        for n, lo, hi, rank, count in self.units:
            out += [n, lo, hi, rank | count << 16]
        for row in self.dq_rank:
            out += row
        return out + list(self.dq_count)


def _kept_spans(sq: int, sk: int, causal: bool, window: int,
                span: int = BWD_SPAN) -> tuple[list[int], list[int]]:
    """For each 64-row query tile, the first and last ``span``-key span
    holding a key that one of its rows attends (every span between holds
    one)."""
    n_sp = math.ceil(sk / span)
    lo, hi = [], []
    for qt in range(math.ceil(sq / BWD_TILE)):
        if causal:
            hi.append(min(BWD_TILE * qt + BWD_TILE - 1, sq - 1) // span)
            lo.append(max(0, BWD_TILE * qt - window + 1) // span
                      if window else 0)
        else:
            lo.append(0)
            hi.append(n_sp - 1)
    return lo, hi


def _pattern(lo: list[int], hi: list[int], n_sp: int, tiles: int) -> list:
    """Units (span, qt_lo, qt_hi) of walks cut at every ``tiles`` query
    tiles, heaviest first; ties by span, then by the higher tiles."""
    units = []
    for top in range(0, len(lo), tiles):
        for n in range(n_sp):
            kept = [qt for qt in range(top, min(len(lo), top + tiles))
                    if lo[qt] <= n <= hi[qt]]
            if kept:
                units.append((n, kept[0], kept[-1] + 1))
    return sorted(units, key=lambda u: (u[1] - u[2], u[0], -u[1]))


@functools.lru_cache(maxsize=256)
def bwd_schedule(b: int, h: int, kv: int, sq: int, sk: int, d: int,
                 causal: bool, window: int,
                 span: int = BWD_SPAN) -> BwdSchedule:
    """The unit list of the backward at one shape, in spans of ``span``
    keys (BWD_SPAN for the bf16 kernel, BWD_F32_SPAN for the fp32 one).
    Each (batch, KV head, key span) walks its kept query tiles.  Causal walks, whose
    length falls with the span, are cut into slices of ``tiles`` query
    tiles, the tallest height among n_qt / k (k = 1..8) whose list holds
    ``BWD_UNITS_PER_SM`` units an SM, else n_qt / 8; full attention's
    walks are all as long, so cutting them evens nothing out and they stay
    whole.  The list is heaviest first, so a unit's ordered sums wait only
    on units earlier in it, which running blocks took before it: no
    deadlock for any number of units or blocks.  Slices of one height
    start at the same query tile, so the spans that add to one dQ tile
    reach it in step, and each waits on the one before it: dQ's sums take
    as many slots as a tile has parts, within ``BWD_DQ_BYTES`` (the fp32
    kernel's whole block waits for a part's turn, yet at granite-3-2b's
    shape it ran as fast with 1, 2 and 4 slots: tools/k6_bwd_sched.py)."""
    lo, hi = _kept_spans(sq, sk, causal, window, span)
    n_qt, n_sp = len(lo), math.ceil(sk / span)
    heights = sorted({math.ceil(n_qt / k) for k in range(1, 9)} if causal
                     else {n_qt}, reverse=True)
    for tiles in heights:
        units = _pattern(lo, hi, n_sp, tiles)
        if len(units) * b * kv >= BWD_UNITS_PER_SM * BWD_SMS:
            break
    sched = _finish(units, n_qt, n_sp, b * kv, h // kv, tiles)
    slot = b * h * n_qt * BWD_TILE * _dq_ld(d) * 4
    return sched._replace(slots=max(1, min(max(sched.dq_count),
                                           BWD_DQ_BYTES // slot)), span=span)


def _dq_ld(d: int) -> int:
    """The row stride of dQ's fp32 sums: D padded to the kernel's boxes."""
    return 64 * math.ceil(d / 64)


def _finish(units: list, n_qt: int, n_sp: int, bkv: int, groups: int,
            tiles: int) -> BwdSchedule:
    """The ranks of each dQ tile's and each span's parts, in list order."""
    dq_rank = [[-1] * n_sp for _ in range(n_qt)]
    dq_count = [0] * n_qt
    parts = [0] * n_sp
    ranked = []
    for n, qt_lo, qt_hi in units:
        for qt in range(qt_lo, qt_hi):
            dq_rank[qt][n] = dq_count[qt]
            dq_count[qt] += 1
        ranked.append([n, qt_lo, qt_hi, parts[n]])
        parts[n] += 1
    return BwdSchedule(tuple((*u, parts[u[0]]) for u in ranked),
                       tuple(map(tuple, dq_rank)), tuple(dq_count), bkv,
                       groups, tiles, min(BWD_SMS, len(units) * bkv))


_PLANS: dict = {}


def _plan_tensor(sched: BwdSchedule, device: torch.device) -> torch.Tensor:
    """The schedule's plan on the card, made once per schedule and device
    (the first call at a shape copies it; a captured CUDA graph replays a
    call that found it made)."""
    key = (sched, str(device))
    if key not in _PLANS:
        _PLANS[key] = torch.tensor(sched.plan(), dtype=torch.int32,
                                   device=device)
    return _PLANS[key]


def _bwd_scratch(sched: BwdSchedule, b: int, h: int, kv: int, sq: int,
                 sk: int, d: int, device, bf16: bool = True) -> list:
    """[row stats, plan (set on the card), n_pat, blocks, slots, dq_acc,
    dkv_acc, counters]: the kernels' scratch, the same on the meta device
    (the dry-run's peak counts it).  The row stats are bf16's tiles of
    lse·log2(e) and delta, fp32's delta (B, H, Sq).  dq_acc (slots, B·H,
    64·n_qt, ld) and dkv_acc are fp32 with rows of ld = 64 or 128 (D padded
    to the kernel's boxes, Sq to its query tiles); dkv_acc is empty unless
    a bf16 span's walk is split (the fp32 kernel sums split spans in dk and
    dv themselves); a counter a (dQ tile, slot)."""
    n_qt = math.ceil(sq / BWD_TILE)
    n_sp = math.ceil(sk / sched.span)
    ld = _dq_ld(d)
    f32 = dict(dtype=torch.float32, device=device)
    split = bf16 and sched.split
    return [torch.empty(b * h * n_qt * 2 * BWD_TILE if bf16 else b * h * sq,
                        **f32), None,
            len(sched.units), sched.blocks, sched.slots,
            torch.empty((sched.slots, b * h, BWD_TILE * n_qt, ld), **f32),
            torch.empty((2, b, kv, sk, ld) if split else (0,), **f32),
            torch.empty(1 + b * h * n_qt * sched.slots + 2 * b * kv * n_sp,
                        dtype=torch.int32, device=device)]
