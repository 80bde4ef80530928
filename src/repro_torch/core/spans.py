"""Named spans of the program's own work, on one clock with the runtime's
task stamps and the profiler's device events: off by default.

The recorder lives in ``core`` so that the train step and the executors
import it without the observability package, which the runtime imports
only where a caller asks for it; ``repro_torch.observability`` exports it
as ``spans`` (beside ``Span`` and ``SpanTrace``) for the readers.

A span records its name, its start and end (``time.monotonic_ns()``, the
clock ``core/simclock.RealClock`` stamps task transitions on, so a span
maps onto a task's stamps by ``RealClock.origin_ns``), the span open on
the same thread when it began (its parent), the thread, and a small
payload dict. The rows go to a ``core/events.Profiler`` (names and
threads interned), one row a span, written under the trace's own lock:
worker threads never take ``engine.lock`` to record.

* **Off** (the default) ``span(...)`` returns one shared null context
  manager after a single module-level check: it records nothing and
  calls nothing on the device.
* ``enable(device_timing=True)`` starts a trace, ``disable()`` ends it
  and returns it (a :class:`SpanTrace`). With device timing on (and a
  CUDA card there) a span opened with ``device=True`` records a
  ``torch.cuda.Event`` pair on the current stream at its start and end;
  the pair is resolved only when the trace is read
  (:meth:`SpanTrace.spans`), after the caller's own synchronise. The
  recorder never synchronises while it records.
* ``enable`` reads ``time.perf_counter_ns`` and ``time.time_ns``, each
  between two reads of ``time.monotonic_ns``, and keeps their offsets
  with the trace, so a reader maps spans onto another clock (a
  profiler's wall-clock device events) without assuming that two clocks
  are one.

Spans named in the program:

* ``step``: ``distributed/train_step.make_train_step``'s step, entry to
  return (host time; the card's idle time inside it);
* ``step.forward``, ``step.backward`` (the recompute under remat
  included), ``step.update`` (AdamW): device pairs;
* ``payload``: ``runtime/real_executors.RealExecutorBase._run`` around a
  task's payload, with ``{uid, stage, backend}``.

The recorder records only on wall-clock runs: nothing in the simulator
(``VirtualClock``) enables it. A Flux task run on a rank group over
several cards (``launch/ranks.py``) records nothing of its ranks' work:
their processes start with the recorder off. ``FuncPoolExecutor``'s
worker processes record nothing either.
"""
from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.events import Profiler

_NULL = nullcontext()
_trace: Optional["SpanTrace"] = None     # the trace being recorded, if any
_switch = threading.Lock()               # serialises enable / disable


@dataclass(frozen=True)
class Span:
    """One span as read back. ``parent`` is the index (in
    :meth:`SpanTrace.spans`) of the span open on the same thread when
    this one began, or None; ``end_ns`` is None for a span still open
    when the trace was read; ``device_ms`` the device pair's elapsed
    milliseconds, or None where the span took none."""
    name: str
    thread: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    args: Dict
    device_ms: Optional[float]


def _offset_ns(read) -> int:
    """``read()`` less ``time.monotonic_ns()`` at the same instant: the
    other clock's reading against the mean of the monotonic readings on
    either side of it."""
    m0 = time.monotonic_ns()
    t = read()
    m1 = time.monotonic_ns()
    return t - (m0 + m1) // 2


class SpanTrace:
    """The spans of one ``enable`` .. ``disable``. ``profiler`` holds one
    row a span: its start (ns after ``origin_ns``) in the time column,
    the thread as the entity, the name, and a payload of ``parent`` (its
    row), ``end`` (ns after ``origin_ns``), ``args`` and the device
    pair until it is resolved. ``origin_ns`` is ``time.monotonic_ns()``
    at ``enable``; ``perf_offset_ns`` and ``wall_offset_ns`` are
    ``perf_counter_ns()`` and ``time_ns()`` less ``monotonic_ns()``, each
    read at ``enable``."""

    def __init__(self, device_timing: bool):
        self.device_timing = device_timing
        self.profiler = Profiler()
        self.perf_offset_ns = _offset_ns(time.perf_counter_ns)
        self.wall_offset_ns = _offset_ns(time.time_ns)
        self.origin_ns = time.monotonic_ns()
        self._lock = threading.Lock()
        self._local = threading.local()          # per thread: open rows

    # ------------------------------------------------------------ clocks
    def to_wall_ns(self, mono_ns: int) -> int:
        """A ``time.monotonic_ns()`` stamp on ``time.time_ns()``'s clock."""
        return mono_ns + self.wall_offset_ns

    def to_perf_ns(self, mono_ns: int) -> int:
        """A ``time.monotonic_ns()`` stamp on ``perf_counter_ns()``'s."""
        return mono_ns + self.perf_offset_ns

    # ------------------------------------------------------------- write
    def _open(self, name: str, device: bool, args: Optional[Dict]) -> int:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        pair = None
        if device and self.device_timing:
            import torch
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
        data = {"parent": stack[-1] if stack else None, "end": None,
                "args": args or {}, "pair": pair}
        thread = threading.current_thread()
        t0 = time.monotonic_ns() - self.origin_ns
        with self._lock:
            row = self.profiler.record(float(t0),
                                       f"{thread.name}/{thread.ident}",
                                       name, data)
        stack.append(row)
        return row

    def _close(self, row: int):
        t1 = time.monotonic_ns() - self.origin_ns
        self._local.stack.pop()
        with self._lock:
            data = self.profiler.payload_at(row)
        if data["pair"] is not None:
            data["pair"][1].record()
        data["end"] = t1

    # -------------------------------------------------------------- read
    def spans(self) -> List[Span]:
        """Every span, in the order they began; device pairs resolved
        (each pair's end waited on: read after the work is done)."""
        with self._lock:
            rows = list(self.profiler.events)
        out = []
        for ev in rows:
            data = ev.data
            ms, pair, end = data.get("device_ms"), data["pair"], data["end"]
            if ms is None and pair is not None and end is not None:
                pair[1].synchronize()
                ms = data["device_ms"] = pair[0].elapsed_time(pair[1])
                data["pair"] = None
            out.append(Span(ev.name, ev.entity, self.origin_ns + int(ev.time),
                            None if end is None else self.origin_ns + end,
                            data["parent"], data["args"], ms))
        return out


class _Open:
    """A span being recorded (the recorder is on)."""
    __slots__ = ("trace", "name", "device", "args", "row")

    def __init__(self, trace: SpanTrace, name: str, device: bool,
                 args: Optional[Dict]):
        self.trace, self.name, self.device, self.args = (trace, name, device,
                                                         args)

    def __enter__(self):
        self.row = self.trace._open(self.name, self.device, self.args)
        return self

    def __exit__(self, *exc):
        self.trace._close(self.row)
        return False


def span(name: str, device: bool = False, args: Optional[Dict] = None):
    """A context manager that records the span ``name`` while a trace is
    on (``device=True``: with a device pair where the trace times the
    device; ``args``: the span's payload); the shared null context
    manager while none is."""
    trace = _trace
    if trace is None:
        return _NULL
    return _Open(trace, name, device, args)


def enable(device_timing: bool = True) -> SpanTrace:
    """Start recording spans into a new trace and return it. Device pairs
    are recorded only where ``device_timing`` is set and CUDA is there."""
    global _trace
    if device_timing:
        import torch
        device_timing = torch.cuda.is_available()
    with _switch:
        if _trace is not None:
            raise RuntimeError("a span trace is already being recorded")
        _trace = SpanTrace(device_timing)
        return _trace


def disable() -> Optional[SpanTrace]:
    """Stop recording; returns the trace that was on (None if none was).
    A span still open finishes its row in that trace."""
    global _trace
    with _switch:
        trace, _trace = _trace, None
    return trace
