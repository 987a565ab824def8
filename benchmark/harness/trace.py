"""Spans and the device trace of a ``--trace 1`` run.

Spans are the benchmark's own, around its calls into each layer of the
program: host-clock intervals (``Spans.span``), kept in memory for the run.

The trace is ``torch.profiler``'s of the device alone (CUDA activity: the
host's operators are not recorded, so the trace costs the host next to
nothing) over the traced window, reduced as ``chip_smoke.py:_report_profile``
reduces it, by kernel name: the device's busy time (the union of its
kernels' and copies' intervals inside the window), each kernel name's time
and calls, the operations that took most time and the longest idle gaps,
each named by the innermost span the host was in. The host's clock and the
trace's are tied by a spin kernel launched on an idle device at a known
host time (``anchor``). The same spin kernel, launched before and after a
call (``mark``), brackets the device work that call enqueued: ``reduce``
sums the device time between each pair of marks (``marked``).
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

ANCHOR_KERNEL = "spin_kernel"
MARK_CYCLES = 100


class Spans:
    """Host-clock spans (``perf_counter`` intervals) by name."""

    def __init__(self):
        self.intervals: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.intervals[name].append((t0, time.perf_counter()))

    def wrap(self, owner, attr: str, name: str, before=None) -> None:
        """Replace ``owner.attr`` by the same call inside span ``name``;
        ``before(*args)`` sees each call's arguments."""
        fn = getattr(owner, attr)
        spans = self

        def spanned(*args, **kwargs):
            if before is not None:
                before(*args, **kwargs)
            with spans.span(name):
                return fn(*args, **kwargs)

        setattr(owner, attr, spanned)

    def clear(self) -> None:
        for v in self.intervals.values():
            v.clear()

    def total(self, name: str) -> float:
        return float(sum(b - a for a, b in self.intervals.get(name, ())))


def profiler():
    import torch

    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


def mark(owner, attr: str, spans: Spans, name: str) -> None:
    """Replace ``owner.attr`` by the same call inside span ``name``, with a
    spin kernel enqueued before and after it: the device work the call
    enqueues lies between the two (one stream)."""
    import torch

    fn = getattr(owner, attr)

    def marked(*args, **kwargs):
        with spans.span(name):
            torch.cuda._sleep(MARK_CYCLES)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda._sleep(MARK_CYCLES)

    setattr(owner, attr, marked)


def anchor() -> float:
    """Launch the anchor kernel on an idle device; its host time."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(1000)
    return t


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce(prof, t_anchor: float, window: Tuple[float, float], spans: Spans,
           top: int = 10) -> Optional[Dict]:
    """busy_s, window_s, per-kernel seconds and calls, the device seconds
    between each pair of marks after the anchor (``marked``; None when they
    do not pair) and the breakdown of the host-clock ``window``; None when
    the trace holds no device time or no anchor."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
              if e.device_type == cuda and not getattr(e, "is_user_annotation", False)]
    marks = [s for s, _, n in device if ANCHOR_KERNEL in n]
    if not device or not marks:
        return None
    zero = min(marks)

    def on_trace(t: float) -> float:  # host perf_counter seconds -> trace us
        return zero + (t - t_anchor) * 1e6

    w0, w1 = on_trace(window[0]), on_trace(window[1])
    per_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    inside = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s or ANCHOR_KERNEL in name:
            continue
        inside.append((s, e))
        per_name[name][0] += (e - s) / 1e6
        per_name[name][1] += 1
    busy = _union(inside)
    spins = sorted(s for s, _, n in device if ANCHOR_KERNEL in n)[1:]
    marked = None
    if len(spins) % 2 == 0:
        work = sorted((s, e) for s, e, n in device if ANCHOR_KERNEL not in n)
        starts = [s for s, _ in work]
        marked = [sum(e - s for s, e in work[bisect.bisect_right(starts, a):
                                             bisect.bisect_left(starts, b)]) / 1e6
                  for a, b in zip(spins[0::2], spins[1::2])]
    notes = sorted((on_trace(a), on_trace(b), n) for n, v in spans.intervals.items()
                   for a, b in v)
    gaps = defaultdict(float)
    edge, at, active = w0, 0, []
    for s, e in busy + [(w1, w1)]:
        if s > edge:
            mid = (s + edge) / 2
            while at < len(notes) and notes[at][0] <= mid:
                active.append(notes[at])
                at += 1
            active = [n for n in active if n[1] >= mid]
            label = min(active, key=lambda n: n[1] - n[0])[2] if active else "outside spans"
            gaps[label] += (s - edge) / 1e6
        edge = max(edge, e)
    ops = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernels": {n: (t, c) for n, (t, c) in per_name.items()},
        "marked": marked,
        "breakdown": {
            "device_ops": [[n[:120], t] for n, (t, _) in ops[:top]],
            "idle_gaps": [[n, t] for n, t in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
        },
    }


def kernel_seconds(kernels: Dict[str, Tuple[float, int]], include, exclude=()) -> float:
    """Device seconds of the kernels whose names hold one of ``include``
    (case-insensitive) and none of ``exclude``."""
    total = 0.0
    for name, (t, _) in kernels.items():
        low = name.lower()
        if any(k.lower() in low for k in include) and not any(k.lower() in low for k in exclude):
            total += t
    return total
