"""The device's timeline of a traced window, from ``torch.profiler``.

``Tracer`` profiles the host (CPU) and the card (CUDA, through CUPTI) over
the window and marks the window itself with a ``bench.window`` range.
``summary`` reduces the trace to what the per-layer metrics and the
breakdown read:

``busy_s``      the union of the intervals in which an operation (a kernel,
                a copy or a set) ran on the card, inside the window (a host
                range's mirror on the device's timeline is no operation);
``window_s``    the window's length on the trace's clock;
``device_ops``  per operation name: launches and device seconds;
``idle_gaps``   the card's idle time inside the window, by what the host was
                doing at each gap's middle (the innermost host range open
                there; gaps under ``SHORT_GAP_NS`` together as one entry).
"""

from __future__ import annotations

import bisect
import collections

import torch

__all__ = ["WINDOW", "Tracer", "summary", "breakdown"]

WINDOW = "bench.window"
SHORT_GAP_NS = 10_000


def _span(e) -> tuple[int, int]:
    start = e.start_ns()
    return start, start + e.duration_ns()


def _annotation(e) -> bool:
    """Whether a device event is a host range's mirror on the device's
    timeline (a ``record_function`` range, the window's own included),
    not an operation that ran there."""
    marked = getattr(e, "is_user_annotation", None)
    return e.name() == WINDOW or (callable(marked) and marked())


class Tracer:
    """``with Tracer() as t: ...`` profiles the block (which synchronizes
    with the card before it ends); ``t.events()`` are the raw events
    afterwards."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._range = torch.profiler.record_function(WINDOW)

    def __enter__(self) -> "Tracer":
        self._prof.__enter__()
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def events(self) -> list:
        return list(self._prof.profiler.kineto_results.events())


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summary(events: list) -> dict | None:
    """The trace reduced; None where it holds no device operation or no
    window range."""
    from torch.autograd import DeviceType

    device, host, win = [], [], None
    for e in events:
        a, b = _span(e)
        if e.device_type() == DeviceType.CUDA:
            if not _annotation(e):
                device.append((a, b, e.name()))
        elif e.name() == WINDOW:
            win = (a, b)
        else:
            host.append((a, b, e.name()))
    if win is None or not device:
        return None
    w0, w1 = win
    ops: dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
    for a, b, name in device:
        ops[name][0] += 1
        ops[name][1] += (b - a) / 1e9
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _ in device
                   if b > w0 and a < w1])
    busy_ns = sum(b - a for a, b in busy)
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = b
    if w1 > edge:
        gaps.append((edge, w1))
    host.sort()
    starts = [a for a, _, _ in host]
    idle: dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        if b - a < SHORT_GAP_NS:
            idle[f"gaps under {SHORT_GAP_NS // 1000} us"] += (b - a) / 1e9
            continue
        idle[_host_at(host, starts, (a + b) // 2)] += (b - a) / 1e9
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_ops": {k: tuple(v) for k, v in ops.items()},
            "idle_gaps": dict(idle)}


def _host_at(host: list, starts: list[int], t: int, reach: int = 4096) -> str:
    """The innermost host range open at ``t``: of those that started last
    before it (``reach`` of them at most), the first still open."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - reach), -1):
        a, b, name = host[j]
        if b >= t:
            return name
    return "no host range open"


def breakdown(s: dict, n: int = 10) -> dict:
    """The ``breakdown`` of a result line: the ``n`` device operations that
    took most time and the ``n`` host ranges the card waited longest on."""
    ops = sorted(s["device_ops"].items(), key=lambda kv: -kv[1][1])[:n]
    gaps = sorted(s["idle_gaps"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[_short(k), v[1]] for k, v in ops],
            "idle_gaps": [[_short(k), v] for k, v in gaps]}


def _short(name: str, width: int = 160) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."
