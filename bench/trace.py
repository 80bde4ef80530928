"""Spans the benchmark records around its calls into the program, and the
device's activity from the profiler's trace, read together.

Spans are host intervals (``time.perf_counter_ns``) named by the
benchmark, recorded from any thread. The trace records the card's
activity alone (kernels, copies, sets): a step's host ops number tens of
thousands, and recording them would slow the host the cells measure. Its
timestamps are on the wall clock (``time.time_ns``), so one pair of
readings of both clocks taken at the window's start maps spans onto it.
"""
from __future__ import annotations

import bisect
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

NAME_CHARS = 160


class Spans:
    """Named host intervals, appended from any thread."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            with self._lock:
                self.items.append((name, t0, t1))


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of intervals as sorted, disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: List[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The intervals of [lo, hi) that ``busy`` (merged) leaves free."""
    out, t = [], lo
    for s, e in busy:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


class DeviceTrace:
    """The card's activity over a window: ``start`` before it, ``stop``
    after it. Then ``kernels`` holds (name, start_ns, end_ns) of every
    device event, on the wall clock, and ``lo``/``hi`` the window."""

    def __init__(self):
        self.kernels: List[Tuple[str, int, int]] = []
        self.lo = self.hi = 0
        self._prof = None
        self._anchor = (0, 0)

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._anchor = (time.perf_counter_ns(), time.time_ns())
        self.lo = self._anchor[1]

    def to_wall(self, pc_ns: int) -> int:
        return self._anchor[1] + (pc_ns - self._anchor[0])

    def stop(self):
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self.hi = self.to_wall(time.perf_counter_ns())
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        self.kernels = [(e.name(), e.start_ns(), e.end_ns()) for e in events
                        if e.device_type() == DeviceType.CUDA
                        and e.end_ns() > e.start_ns()]
        self._prof = None

    # ---------------------------------------------------------------- reads
    def busy(self) -> List[Tuple[int, int]]:
        return merge([(max(s, self.lo), min(e, self.hi))
                      for _, s, e in self.kernels
                      if e > self.lo and s < self.hi])

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def device_time(self, key: str) -> Tuple[float, int]:
        """(seconds, launches) of the events whose name holds ``key``."""
        hits = [(e - s) for n, s, e in self.kernels if key in n]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:NAME_CHARS], v] for k, v in rows]

    def idle_gaps(self, spans: Spans, n: int = 10) -> List[List]:
        """The ``n`` longest idle stretches of the card, each named by the
        innermost benchmark span that covers its middle (``host-other``
        where none does)."""
        walled = sorted((self.to_wall(a), self.to_wall(b), name)
                        for name, a, b in spans.items)
        starts = [w[0] for w in walled]
        out = []
        for s, e in sorted(gaps(self.busy(), self.lo, self.hi),
                           key=lambda g: g[0] - g[1])[:n]:
            mid = (s + e) // 2
            cover = [w for w in walled[:bisect.bisect_right(starts, mid)]
                     if w[1] >= mid]
            name = (min(cover, key=lambda w: w[1] - w[0])[2] if cover
                    else "host-other")
            out.append([name, (e - s) / 1e9])
        return out
