"""Clocks for the runtime: a discrete-event virtual clock (paper-scale
simulation of 4-1024 node allocations) and a wall clock (real execution).

Both expose ``now()`` and ``schedule(delay, fn, *args)``; the engine decides
which to drive. The virtual clock is a classic event heap with stable FIFO
tie-breaking, cancelable events, and watchdog-safe reentrancy (callbacks may
schedule/cancel freely). Heap entries are ``(time, seq, handle)`` tuples so
sift comparisons run entirely in C (the unique ``seq`` guarantees the handle
is never compared), and a live-event counter makes ``pending`` O(1).
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, List, Optional, Tuple


class ScheduledEvent:
    """Cancelation handle for a scheduled callback. ``canceled`` doubles as
    the consumed flag once the event fires, keeping ``cancel`` idempotent
    and the clock's live counter exact."""

    __slots__ = ("fn", "args", "canceled", "_clock")

    def __init__(self, fn: Callable, args: tuple, clock: "VirtualClock"):
        self.fn = fn
        self.args = args
        self.canceled = False
        self._clock = clock

    def cancel(self):
        if not self.canceled:
            self.canceled = True
            self._clock._live -= 1


class VirtualClock:
    """Deterministic discrete-event clock."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._heap: List[Tuple[float, int, ScheduledEvent]] = []
        self._seq = itertools.count()
        self._live = 0
        self.fired_total = 0

    def now(self) -> float:
        return self._now

    def schedule(self, delay: float, fn: Callable, *args) -> ScheduledEvent:
        ev = ScheduledEvent(fn, args, self)
        t = self._now + delay if delay > 0.0 else self._now
        heapq.heappush(self._heap, (t, next(self._seq), ev))
        self._live += 1
        return ev

    def run(self, until: Optional[float] = None, max_events: int = 50_000_000
            ) -> int:
        """Drain events (up to ``until`` if given). Returns #events fired."""
        fired = 0
        heap = self._heap
        pop = heapq.heappop
        while heap and fired < max_events:
            if until is not None and heap[0][0] > until:
                break
            t, _, ev = pop(heap)
            if ev.canceled:
                continue
            ev.canceled = True            # consumed: cancel() is now a no-op
            self._live -= 1
            self._now = t
            ev.fn(*ev.args)
            fired += 1
        self.fired_total += fired
        if until is not None and self._now < until and not heap:
            self._now = until
        if fired >= max_events:
            raise RuntimeError("VirtualClock: event budget exhausted "
                               "(runaway simulation?)")
        return fired

    @property
    def pending(self) -> int:
        return self._live


class RealClock:
    """Wall clock; schedule() uses daemon timer threads. ``now()`` is the
    seconds of ``time.monotonic()`` since ``origin_ns``, the clock's
    ``time.monotonic_ns()`` at its start: a stamp taken on that clock
    elsewhere (``core/spans.py``) maps onto ``now()``'s axis by
    ``(ns - origin_ns) / 1e9``."""

    # dead timers are pruned in batches: the liveness filter is O(n), so
    # rebuilding the list on every schedule() turns sustained scheduling
    # into O(n^2) — amortize it by pruning only once the list has doubled
    # since the last prune (stays amortized-O(1) even with many timers
    # simultaneously alive)
    PRUNE_THRESHOLD = 256

    def __init__(self):
        self.origin_ns = time.monotonic_ns()
        self._t0 = self.origin_ns / 1e9
        self._timers: List[threading.Timer] = []
        self._prune_at = self.PRUNE_THRESHOLD

    def now(self) -> float:
        return time.monotonic() - self._t0

    def from_monotonic(self, t: float) -> float:
        """Map a raw ``time.monotonic()`` stamp (CLOCK_MONOTONIC is
        system-wide, so worker processes share it) onto this clock."""
        return t - self._t0

    def schedule(self, delay: float, fn: Callable, *args):
        t = threading.Timer(max(0.0, delay), fn, args=args)
        t.daemon = True
        t.start()
        if len(self._timers) >= self._prune_at:
            self._timers = [p for p in self._timers if p.is_alive()]
            self._prune_at = max(self.PRUNE_THRESHOLD,
                                 2 * len(self._timers))
        self._timers.append(t)
        return t

    def cancel_all(self):
        for t in self._timers:
            t.cancel()
        self._timers.clear()

    def run(self, until: Optional[float] = None, max_events: int = 0) -> int:
        if until is not None:
            time.sleep(max(0.0, until - self.now()))
        return 0
