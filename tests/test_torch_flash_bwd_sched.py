"""The bf16 K6 backward's unit list (``kernels.flash_attention.bwd_schedule``)
and its scratch, on the CPU.

The fused kernel (``csrc/flash_attention_bwd.cu``, ``flash_bwd_wgmma_kernel``)
walks the list a unit at a time from a ticket and sums each dQ tile's parts
(one a 128-key span) and each split span's dK/dV parts (one a walk slice)
in the list's order, a counter a tile deciding whose turn it is.  What the
kernel relies on is checked here at every shape chip_smoke.py's phase 7
runs (``K6_BWD_SHAPES`` and ``K6_BWD_EDGES``):

  * every (query tile, key span) pair that the mask keeps is walked by
    exactly one unit, and no other pair is; each unit lies in one slice;
  * every ordered sum's parts are ranked in list order, so a part waits
    only on units earlier in the list (taken first by the ticket: no
    deadlock, whatever the number of blocks), dQ's in each of its slots;
  * causal walks cut until the list holds 3 units an SM, full attention's
    left whole; each free SM taking the next unit, the busiest of 132
    walks within 1.15x of an even share at granite-3-2b's, qwen3-14b's and
    Zamba2's training shapes;
  * dQ's slots: as many as a tile has parts as far as they fit in
    ``BWD_DQ_BYTES`` (the seamless cross-attention's chains of 8 become 4
    of 2);
  * the plan the kernel reads, and the scratch the meta path allocates as
    the card does (the dry-run's peak counts it).
"""

import heapq
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import cost, ref
from repro_torch.kernels.flash_attention import (BWD_DQ_BYTES,
                                                 BWD_F32_SPAN, BWD_SMS,
                                                 BWD_SPAN, BWD_TILE,
                                                 BWD_UNITS_PER_SM,
                                                 _kept_spans, _pattern,
                                                 bwd_schedule,
                                                 flash_attention_bwd)
from repro_torch.launch.dryrun import ALLOC_ROUND, CostCounter

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)

# (B, H, KV, S, D, Sk, causal, window)
SHAPES = {**{name: shape for name, shape in SMOKE.K6_BWD_SHAPES},
          **{f"edge {i}": shape for i, shape in enumerate(SMOKE.K6_BWD_EDGES)}}
BALANCED = ("granite-3-2b train", "qwen3-14b", "zamba2-1.2b train")


def _schedule(shape, span=BWD_SPAN):
    b, h, kv, s, d, sk, causal, window = shape
    return bwd_schedule(b, h, kv, s, sk, d, causal, window, span)


def _kept_pairs(shape, span=BWD_SPAN) -> set[tuple[int, int]]:
    """(query tile, key span) pairs holding a (row, key) the mask keeps."""
    _, _, _, s, _, sk, causal, window = shape
    mask = (ref.attention_mask(s, sk, window, "cpu") if causal
            else torch.ones(s, sk, dtype=torch.bool))
    return {(qt, n) for qt in range(math.ceil(s / BWD_TILE))
            for n in range(math.ceil(sk / span))
            if mask[BWD_TILE * qt:BWD_TILE * qt + BWD_TILE,
                    span * n:span * n + span].any()}


def _check_cover(shape, span):
    sched = _schedule(shape, span)
    assert sched.span == span
    walked = [(qt, n) for n, lo, hi, _, _ in sched.units
              for qt in range(lo, hi)]
    assert len(walked) == len(set(walked))
    assert set(walked) == _kept_pairs(shape, span)
    for n, lo, hi, _, _ in sched.units:     # one slice of `tiles` tiles
        assert lo < hi and lo // sched.tiles == (hi - 1) // sched.tiles


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_units_cover_every_kept_pair_once(name):
    _check_cover(SHAPES[name], BWD_SPAN)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fp32_units_cover_every_kept_pair_once(name):
    """The fp32 kernel's list, in 64-key spans (its fp32 tiles take twice
    the shared memory of bf16's), holds every kept pair once too."""
    _check_cover(SHAPES[name], BWD_F32_SPAN)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_ordered_sums_wait_only_on_earlier_units(name):
    """Ranks count 0, 1, ... in list order for every dQ tile and every
    span's dK/dV, so each part's predecessor comes earlier in the list (in
    the full list, pattern unit p of (batch, KV head) x is unit
    p·B·KV + x, and a tile's parts share x); a dQ part of rank r waits on
    rank r - slots, the one before it in its slot, so on an earlier unit
    too."""
    _check_order(SHAPES[name], BWD_SPAN)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fp32_ordered_sums_wait_only_on_earlier_units(name):
    """The same for the fp32 kernel's list, whose whole block waits for a
    part's turn: no part waits on a unit later in the list."""
    _check_order(SHAPES[name], BWD_F32_SPAN)


def _check_order(shape, span):
    sched = _schedule(shape, span)
    where = {}
    for p, (n, lo, hi, _, _) in enumerate(sched.units):
        for qt in range(lo, hi):
            where[qt, n] = p
    for qt, ranks in enumerate(sched.dq_rank):
        parts = sorted((r, where[qt, n]) for n, r in enumerate(ranks)
                       if r >= 0)
        assert [r for r, _ in parts] == list(range(sched.dq_count[qt]))
        assert [p for _, p in parts] == sorted(p for _, p in parts)
        assert all(ranks[n] < 0 for n in range(len(ranks))
                   if (qt, n) not in where)
    for n in {u[0] for u in sched.units}:
        parts = [(p, u[3], u[4]) for p, u in enumerate(sched.units)
                 if u[0] == n]
        assert [r for _, r, _ in parts] == list(range(len(parts)))
        assert all(c == len(parts) for _, _, c in parts)


def _makespan(sched) -> int:
    """Pairs the busiest SM walks when each of 132 takes the next unit of
    the list when free (the kernel's ticket)."""
    free = [0] * min(BWD_SMS, sched.n_units)
    for n, lo, hi, _, _ in sched.units:
        for _ in range(sched.bkv):
            heapq.heapreplace(free, free[0] + sched.groups * (hi - lo))
    return max(free)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_causal_walks_cut_to_units_an_sm(name):
    """A causal list holds ``BWD_UNITS_PER_SM`` units an SM at the tallest
    slice height n_qt / k that reaches it (or is cut at k = 8); full
    attention's walks are whole."""
    b, h, kv, s, _, sk, causal, window = SHAPES[name]
    sched = _schedule(SHAPES[name])
    n_qt = math.ceil(s / BWD_TILE)
    want = BWD_UNITS_PER_SM * BWD_SMS
    if not causal:
        assert sched.tiles == n_qt and not sched.split
        return
    heights = sorted({math.ceil(n_qt / k) for k in range(1, 9)},
                     reverse=True)
    assert sched.tiles in heights
    assert sched.n_units >= want or sched.tiles == heights[-1]
    lo, hi = _kept_spans(s, sk, causal, window)
    for taller in heights[:heights.index(sched.tiles)]:
        assert len(_pattern(lo, hi, math.ceil(sk / BWD_SPAN),
                            taller)) * b * kv < want


@pytest.mark.parametrize("name", BALANCED)
def test_makespan_near_an_even_share(name):
    """Greedy list scheduling on 132 SMs, heaviest first: the busiest SM
    walks within 1.15x of the pairs over 132 (granite 72 of 65.9, qwen3
    90 of 82.4, Zamba2 68 of 65.9), and granite's and qwen3's spans are
    cut into slices (unsplit, one span's walk alone is 1.9x the share)."""
    sched = _schedule(SHAPES[name])
    share = sched.pairs() / BWD_SMS
    assert _makespan(sched) <= 1.15 * share, (_makespan(sched), share)
    assert sched.blocks == min(BWD_SMS, sched.n_units)
    _, h, kv, s, _, _, _, _ = SHAPES[name]
    assert sched.split == (name != "zamba2-1.2b train")
    if sched.split:
        longest = (h // kv) * math.ceil(s / BWD_TILE)
        assert longest > 1.15 * share


@pytest.mark.parametrize("name", BALANCED)
def test_fp32_makespan_near_an_even_share(name):
    """The fp32 list on 132 SMs (one block an SM): 64-key spans make twice
    the units, so the busiest SM walks within 1.1x of an even share."""
    sched = _schedule(SHAPES[name], BWD_F32_SPAN)
    share = sched.pairs() / BWD_SMS
    assert _makespan(sched) <= 1.1 * share, (_makespan(sched), share)
    assert sched.blocks == min(BWD_SMS, sched.n_units)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fp32_plan_layout(name):
    """The plan's layout in the fp32 kernel's 64-key spans."""
    _check_plan(SHAPES[name], BWD_F32_SPAN)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_layout(name):
    """4 ints a pattern unit (span, qt_lo, qt_hi, rank | count << 16), then
    dq_rank[qt][n], then dq_count[qt], as ``Plan`` reads them."""
    _check_plan(SHAPES[name], BWD_SPAN)


def _check_plan(shape, span):
    sched = _schedule(shape, span)
    plan = sched.plan()
    _, _, _, s, _, sk, _, _ = shape
    n_qt, n_sp, n_pat = math.ceil(s / BWD_TILE), math.ceil(sk / span), \
        len(sched.units)
    assert len(plan) == 4 * n_pat + n_qt * n_sp + n_qt
    for p, (n, lo, hi, rank, count) in enumerate(sched.units):
        assert plan[4 * p:4 * p + 4] == [n, lo, hi, rank | count << 16]
    for qt in range(n_qt):
        for n in range(n_sp):
            assert plan[4 * n_pat + qt * n_sp + n] == sched.dq_rank[qt][n]
        assert plan[4 * n_pat + n_qt * n_sp + qt] == sched.dq_count[qt]
    assert max(plan) < 2 ** 31


def _rounded(nbytes: int) -> int:
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["granite-3-2b train", "zamba2-1.2b train",
                                  "edge 1"])
def test_meta_path_allocates_the_scratch(name, dtype):
    """Under the dry-run's counter a meta call's peak (its inputs made
    before it) is the gradients plus the kernel's scratch: the row stats
    (bf16: lse·log2 e and delta in 64-row tiles; fp32: the (B, H, Sq)
    delta), dQ's fp32 sum (rows padded to 64 or 128 columns and whole query
    tiles) in each of its slots, bf16 dK/dV's where a span is split (the
    fp32 kernel sums those in dk and dv), and the counters (spans of 128
    keys in bf16, 64 in fp32)."""
    b, h, kv, s, d, sk, causal, window = SHAPES[name]
    meta = dict(device="meta", dtype=dtype)
    q, do, o = (torch.empty(b, h, s, d, **meta) for _ in range(3))
    k, v = (torch.empty(b, kv, sk, d, **meta) for _ in range(2))
    lse = torch.empty(b, h, s, device="meta")
    e = q.element_size()
    want = _rounded(b * h * s * d * e) + 2 * _rounded(b * kv * sk * d * e)
    bf16 = dtype == torch.bfloat16
    span = BWD_SPAN if bf16 else BWD_F32_SPAN
    sched = bwd_schedule(b, h, kv, s, sk, d, causal, window, span)
    n_qt, n_sp, ld = (math.ceil(s / BWD_TILE), math.ceil(sk / span),
                      64 * math.ceil(d / 64))
    slots = sched.slots
    want += (_rounded(b * h * n_qt * 128 * 4 if bf16 else b * h * s * 4)
             + _rounded(slots * b * h * n_qt * BWD_TILE * ld * 4)
             + _rounded(4 * (1 + b * h * n_qt * slots + 2 * b * kv * n_sp)))
    if bf16 and sched.split:
        want += _rounded(2 * b * kv * sk * ld * 4)
    with CostCounter() as counter, cost.recording(counter):
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, causal, window)
    assert counter.peak == want, (counter.peak, want)
    assert counter.launches["flash_attention_bwd"] == 1
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_dq_slots_fit_the_budget(name):
    """As many slots as the most parts a dQ tile has, as far as
    ``BWD_DQ_BYTES`` holds them (and always one): the seamless
    cross-attention's 8 parts a tile go into 4 slots of 2 MiB, chains of
    2, its encoder's and its causal decoder's at the train inputs' 1024
    frames and tokens into 2 slots of 4 MiB, chains of 4; the other
    training shapes' single slot is already past the budget."""
    b, h, _, s, d, _, _, _ = SHAPES[name]
    sched = _schedule(SHAPES[name])
    slot = b * h * math.ceil(s / BWD_TILE) * BWD_TILE * 64 * math.ceil(
        d / 64) * 4
    most = max(sched.dq_count)
    assert 1 <= sched.slots <= most
    assert sched.slots == most or (sched.slots + 1) * slot > BWD_DQ_BYTES
    assert sched.slots == 1 or sched.slots * slot <= BWD_DQ_BYTES
    if name == "seamless-m4t-large-v2 cross-attention":
        assert (sched.slots, most) == (4, 8)
    elif name in ("seamless-m4t-large-v2 train",
                  "seamless-m4t-large-v2 decoder train"):
        assert (sched.slots, most) == (2, 8)
    elif not name.startswith("edge"):
        assert sched.slots == 1


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fp32_dq_slots_fit_the_budget(name):
    """The fp32 list's slots: as many as a tile's parts (64-key spans: up
    to 32 at 2048 keys) as far as ``BWD_DQ_BYTES`` holds them: one slot of
    16 MiB at granite-3-2b's and Zamba2's shapes, whose tiles take up to
    32 parts in one chain."""
    b, h, _, s, d, _, _, _ = SHAPES[name]
    sched = _schedule(SHAPES[name], BWD_F32_SPAN)
    slot = b * h * math.ceil(s / BWD_TILE) * BWD_TILE * 64 * math.ceil(
        d / 64) * 4
    most = max(sched.dq_count)
    assert 1 <= sched.slots <= most
    assert sched.slots == most or (sched.slots + 1) * slot > BWD_DQ_BYTES
    assert sched.slots == 1 or sched.slots * slot <= BWD_DQ_BYTES
    if name in ("granite-3-2b train", "zamba2-1.2b train"):
        assert (sched.slots, most) == (1, 32)
