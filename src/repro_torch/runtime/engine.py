"""Execution engines: the pluggable substrate under the Agent.

An :class:`Engine` bundles everything the agent's dispatch pipeline and the
executors need from their environment — a clock, an event scheduler, a
profiler, seeded noise, and platform-level srun slot accounting — behind one
interface, so the *same* task-management code (routing, retries, speculation,
campaigns) runs on either implementation:

* :class:`SimEngine`  — discrete-event virtual clock (paper-scale simulation,
  4-1024 node allocations, deterministic).
* :class:`RealEngine` — wall clock + timer threads; payloads actually execute
  on this host. All runtime callbacks are serialized under ``engine.lock`` so
  the single-threaded agent logic holds unchanged.

This mirrors RADICAL-Pilot's layering (arXiv:2103.00091): one task-management
pipeline over interchangeable runtime backends.
"""
from __future__ import annotations

import gc
import math
import random
import threading
import time
from abc import ABC, abstractmethod
from typing import Callable, Optional

import numpy as np

from repro_torch.core import calibration as CAL
from repro_torch.core.events import Profiler
from repro_torch.core.simclock import RealClock, VirtualClock


class Engine(ABC):
    """Shared runtime state: clock, trace, seeded noise, srun slots.

    ``mode`` selects which executor implementations the registry builds
    ("sim" -> discrete-event models, "real" -> thread/subprocess backends).
    """

    mode: str = "sim"
    startup_overhead_s: float = 0.0

    def __init__(self, seed: int = 0,
                 srun_cap: int = CAL.SRUN_CONCURRENCY_CAP):
        self.profiler = Profiler()
        self.rng = random.Random(seed)
        # seeded normal-deviate buffer for `noisy`: numpy fills 8k draws at
        # C speed; random.gauss was ~1.3us per sampled launch on the hot
        # path
        self._np_rng = np.random.default_rng(seed)
        self._normal_buf = None
        self._normal_pos = 0
        self.srun_cap = srun_cap
        self._srun_used = 0
        self.duration_fn: Optional[Callable] = None
        # serializes all runtime callbacks; uncontended (same-thread) in sim
        self.lock = threading.RLock()

    # ------------------------------------------------------------------ time
    def now(self) -> float:
        return self.clock.now()

    @property
    def events_fired(self) -> int:
        """Total scheduler events fired so far (0 on wall-clock engines);
        benchmarks report sim-events/s from this."""
        return getattr(self.clock, "fired_total", 0)

    @abstractmethod
    def schedule(self, delay: float, fn: Callable, *args):
        """Run ``fn(*args)`` after ``delay`` engine-seconds."""

    def call_soon(self, fn: Callable, *args):
        """Run ``fn(*args)`` as soon as the engine is idle: after the
        current event on the sim engine (same virtual time, deterministic
        order), on a prompt timer on the real engine. The campaign
        scheduler coalesces its placement passes through this."""
        return self.schedule(0.0, fn, *args)

    @abstractmethod
    def drain(self, predicate: Optional[Callable[[], bool]] = None,
              timeout: Optional[float] = None,
              max_events: int = 50_000_000) -> bool:
        """Advance the engine until ``predicate()`` holds. Returns the final
        predicate value (True when no predicate is given).

        ``timeout`` is *wall-clock* seconds: it bounds how long a RealEngine
        blocks. A SimEngine runs at virtual speed and is bounded by
        ``max_events`` instead — it drains its event heap regardless of
        ``timeout``. Callback exceptions propagate out of drain on both
        engines."""

    def notify(self):
        """Wake ``drain`` waiters after out-of-band state changes."""

    def shutdown(self):
        """Release engine resources (timers, pools)."""

    # ----------------------------------------------------------------- noise
    def noisy(self, mean: float, sigma: float = 0.0) -> float:
        if sigma <= 0:
            return mean
        buf = self._normal_buf
        pos = self._normal_pos
        if buf is None or pos >= 8192:
            buf = self._normal_buf = self._np_rng.standard_normal(8192)
            pos = 0
        self._normal_pos = pos + 1
        return mean * math.exp(sigma * buf[pos])

    def actual_duration(self, task) -> float:
        if self.duration_fn is not None:
            dur = max(0.0, self.duration_fn(task))
        else:
            dur = task.description.duration
        # checkpoint-aware restart: progress persisted by a prior attempt
        # shortens the rerun instead of restarting from zero
        progress = getattr(task, "progress", 0.0)
        if progress > 0.0:
            dur = max(dur - progress, 1e-6)
        return dur

    # --- platform srun slot accounting (Frontier cap, §4.1.1) ---------------
    @property
    def srun_slots_free(self) -> int:
        return self.srun_cap - self._srun_used

    def take_srun_slot(self):
        assert self._srun_used < self.srun_cap, "srun cap violated"
        self._srun_used += 1

    def release_srun_slot(self):
        self._srun_used = max(0, self._srun_used - 1)


class SimEngine(Engine):
    """Discrete-event engine: virtual clock + seeded noise (paper scale)."""

    mode = "sim"
    startup_overhead_s = CAL.AGENT_STARTUP_S

    def __init__(self, seed: int = 0,
                 srun_cap: int = CAL.SRUN_CONCURRENCY_CAP):
        super().__init__(seed, srun_cap)
        self.clock = VirtualClock()
        if type(self) is SimEngine:
            # bypass the delegation layer on the two hottest engine calls
            # (subclasses that override now/schedule keep their methods)
            self.now = self.clock.now
            self.schedule = self.clock.schedule

    def schedule(self, delay: float, fn: Callable, *args):
        return self.clock.schedule(delay, fn, *args)

    def drain(self, predicate: Optional[Callable[[], bool]] = None,
              timeout: Optional[float] = None,
              max_events: int = 50_000_000) -> bool:
        # timeout is a wall-clock bound (see Engine.drain): the virtual
        # clock drains its whole heap, bounded by max_events.
        # The sim allocates no reference cycles in steady state, so pause
        # the cyclic GC for the drain — generational collections otherwise
        # rescan millions of live tasks/trace rows (~25% of wall time on a
        # 100k-task campaign).
        was_enabled = gc.isenabled()
        if was_enabled:
            gc.disable()
        try:
            self.clock.run(max_events=max_events)
        finally:
            if was_enabled:
                gc.enable()
        return predicate() if predicate is not None else True


class RealEngine(Engine):
    """Wall-clock engine: timers + worker threads executing real payloads.

    Every scheduled callback runs holding ``self.lock``; executors commit
    task state transitions under the same lock, so agent/campaign logic sees
    the exact serialization discipline the simulator provides for free.
    """

    mode = "real"
    startup_overhead_s = 0.0

    def __init__(self, seed: int = 0,
                 srun_cap: int = CAL.SRUN_CONCURRENCY_CAP):
        super().__init__(seed, srun_cap)
        self.clock = RealClock()
        self._cond = threading.Condition(self.lock)
        self._callback_error: Optional[BaseException] = None

    def schedule(self, delay: float, fn: Callable, *args):
        def fire():
            with self._cond:
                try:
                    fn(*args)
                except BaseException as e:      # noqa: BLE001
                    # timer threads must not swallow errors: stash the first
                    # one and re-raise it from drain() (sim-mode parity,
                    # where callback errors propagate out of clock.run)
                    if self._callback_error is None:
                        self._callback_error = e
                self._cond.notify_all()
        return self.clock.schedule(delay, fire)

    def notify(self):
        with self._cond:
            self._cond.notify_all()

    def _check_error(self):
        if self._callback_error is not None:
            err, self._callback_error = self._callback_error, None
            raise err

    def drain(self, predicate: Optional[Callable[[], bool]] = None,
              timeout: Optional[float] = None,
              max_events: int = 50_000_000) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._check_error()
            if predicate is None:
                return True
            while not predicate():
                # short re-check interval guards against missed wakeups
                wait_s = 0.1
                if deadline is not None:
                    wait_s = min(wait_s, deadline - time.monotonic())
                    if wait_s <= 0:
                        return predicate()
                self._cond.wait(wait_s)
                self._check_error()
            return True

    def shutdown(self):
        self.clock.cancel_all()
