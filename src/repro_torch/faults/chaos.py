"""Chaos engineering for the task runtime: planned node and pilot faults.

The paper's runtime comparison is framed around *sustained* throughput on
machines where node MTBF at scale makes failures routine; a runtime that
only performs on a healthy machine does not reproduce the operating point.
This module injects the two failure domains above single-task faults:

* **node failure** — a node leaves its backend's ``NodePool`` for good:
  every task with an allocation touching it fails through ``on_failure``
  (feeding the agent's retry/backoff path), and the campaign scheduler's
  placement view shrinks (``CampaignScheduler.on_node_failure``) so
  admission respects the degraded capacity. Real-mode backends have no
  node pools; they emulate the loss by dropping one worker and failing one
  running payload.
* **pilot failure** — a whole pilot dies: its agent evacuates every
  non-terminal task and the scheduler requeues all of them onto surviving
  pilots (``CampaignScheduler.fail_pilot``), recording per-task
  ``sched:requeue`` lineage.

Faults are described by a :class:`FaultPlan` (explicit events, a Poisson
process, or a target node-loss fraction) and driven by a
:class:`ChaosController`, which schedules every event on the pilot
engine — discrete events under ``SimEngine``, timer callbacks under
``RealEngine`` — so one plan runs identically on both engines. All
randomness comes from the controller's own seeded RNG, never from
``engine.rng``, so injecting chaos does not perturb the golden traces of
the underlying workload model.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# trace-name registry (entity = "chaos"): injection events recorded by the
# controller; `chaos:pilot_fail` is recorded by CampaignScheduler.fail_pilot
# (entity = scheduler uid) and re-exported here so the observability layer
# has one registry per failure domain
TRACE_NAMES: Dict[str, str] = {
    "node_fail": "chaos:node_fail",
    "pilot_fail": "chaos:pilot_fail",
    "skip": "chaos:skip",
}


@dataclass(frozen=True)
class FaultEvent:
    """One planned fault.

    ``t`` is seconds after :meth:`ChaosController.arm` (engine clock).
    ``pilot`` is a scheduler view index, or -1 to pick a live pilot at
    random. For node faults, ``backend`` restricts the target backend by
    name ("" = any) and ``node`` pins a pool node id (-1 = random live
    node on the chosen backend).
    """

    t: float
    kind: str                      # "node" | "pilot"
    pilot: int = -1
    backend: str = ""
    node: int = -1

    def __post_init__(self):
        if self.kind not in ("node", "pilot"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.t < 0.0:
            raise ValueError("fault time must be >= 0")


@dataclass
class FaultPlan:
    """An ordered set of fault events; build explicitly or generate."""

    events: List[FaultEvent] = field(default_factory=list)

    def __iter__(self):
        return iter(sorted(self.events, key=lambda e: e.t))

    def __len__(self):
        return len(self.events)

    def add(self, event: FaultEvent) -> "FaultPlan":
        self.events.append(event)
        return self

    def merge(self, other: "FaultPlan") -> "FaultPlan":
        return FaultPlan(self.events + other.events)

    # ------------------------------------------------------------ generators
    @classmethod
    def node_loss(cls, n_nodes: int, fraction: float, horizon: float,
                  seed: int = 0, pilot: int = -1,
                  backend: str = "") -> "FaultPlan":
        """Lose ``fraction`` of ``n_nodes`` at uniform-random times in
        (0, horizon) — the acceptance shape: a campaign under 5-15% node
        loss. Victim nodes are left to the controller (-1 = random live)."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")
        rng = random.Random(seed)
        k = int(round(n_nodes * fraction))
        times = sorted(rng.uniform(horizon * 0.02, horizon)
                       for _ in range(k))
        return cls([FaultEvent(t, "node", pilot=pilot, backend=backend)
                    for t in times])

    @classmethod
    def poisson(cls, horizon: float, node_mtbf: Optional[float] = None,
                pilot_mtbf: Optional[float] = None,
                seed: int = 0) -> "FaultPlan":
        """Memoryless failure processes with the given mean times between
        failures, truncated at ``horizon``."""
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        for kind, mtbf in (("node", node_mtbf), ("pilot", pilot_mtbf)):
            if not mtbf or mtbf <= 0.0:
                continue
            t = rng.expovariate(1.0 / mtbf)
            while t < horizon:
                events.append(FaultEvent(t, kind))
                t += rng.expovariate(1.0 / mtbf)
        return cls(events)


class ChaosController:
    """Drives a :class:`FaultPlan` against a ``CampaignScheduler``.

    Usage::

        sched = CampaignScheduler(...).add_pilot(p0, p1)
        chaos = ChaosController(sched, plan, seed=7)
        chaos.arm()            # schedules every event on the engine
        ...run the campaign...
        chaos.stats()          # {"node_failures": ..., "pilot_failures": ...}

    The controller is engine-agnostic: ``engine.schedule`` delivers the
    events as discrete simulation events or as real timer callbacks, and
    every injection commits under ``engine.lock``. Events that cannot fire
    safely (last surviving pilot, no node capacity left) are skipped and
    counted, never raised — chaos must not crash the run it is testing.
    """

    def __init__(self, scheduler, plan: FaultPlan, seed: int = 0):
        if scheduler.engine is None:
            raise RuntimeError("scheduler has no pilots; add_pilot first")
        self.sched = scheduler
        self.engine = scheduler.engine
        self.plan = plan
        self.rng = random.Random(seed)
        self.injected: List[Dict[str, Any]] = []
        self.skipped = 0
        self._armed = False

    # ---------------------------------------------------------------- arming
    def arm(self):
        """Schedule every planned event relative to now. Idempotent-ish:
        arming twice would double-inject, so it is refused."""
        if self._armed:
            raise RuntimeError("chaos plan already armed")
        self._armed = True
        for ev in self.plan:
            self.engine.schedule(max(ev.t, 1e-9), self._fire, ev)

    # --------------------------------------------------------------- firing
    def _fire(self, ev: FaultEvent):
        with self.engine.lock:
            if ev.kind == "pilot":
                self._fail_pilot(ev)
            else:
                self._fail_node(ev)

    def _live_views(self):
        return [v for v in self.sched.views if not v.dead]

    def _pick_view(self, ev: FaultEvent):
        live = self._live_views()
        if ev.pilot >= 0:
            v = self.sched.views[ev.pilot]
            return v if not v.dead else None
        return self.rng.choice(live) if live else None

    def _skip(self, ev: FaultEvent, why: str):
        self.skipped += 1
        self.engine.profiler.record(self.engine.now(), "chaos",
                                    TRACE_NAMES["skip"],
                                    {"kind": ev.kind, "why": why})

    def _fail_pilot(self, ev: FaultEvent):
        view = self._pick_view(ev)
        if view is None:
            return self._skip(ev, "no live pilot")
        if len(self._live_views()) < 2:
            return self._skip(ev, "last pilot")
        victims = self.sched.fail_pilot(view.index)
        self.injected.append({"t": self.engine.now(), "kind": "pilot",
                              "pilot": view.index,
                              "n_victims": len(victims)})

    def _fail_node(self, ev: FaultEvent):
        view = self._pick_view(ev)
        if view is None:
            return self._skip(ev, "no live pilot")
        ex, node = self._pick_node(view.agent, ev)
        if ex is None:
            return self._skip(ev, "no node capacity")
        victims = ex.fail_node(node, "node failure")
        if victims is None:
            return self._skip(ev, "node not owned")
        self.sched.on_node_failure(view.index, node)
        self.engine.profiler.record(
            self.engine.now(), "chaos", TRACE_NAMES["node_fail"],
            {"pilot": view.index, "backend": ex.name, "node": node,
             "n_victims": len(victims)})
        self.injected.append({"t": self.engine.now(), "kind": "node",
                              "pilot": view.index, "backend": ex.name,
                              "node": node, "n_victims": len(victims)})

    def _pick_node(self, agent, ev: FaultEvent):
        """Choose (executor, node id). Pool-backed backends are preferred
        (a real NodePool shrinks); pool-less real backends come last with a
        nominal node id — their ``fail_node`` emulates the loss. A pool
        must keep >= 1 node so the backend stays schedulable."""
        pooled, poolless = [], []
        for name, ex in agent.backends.items():
            if not ex.alive:
                continue
            if ev.backend and name != ev.backend:
                continue
            nodes = ex.live_nodes()
            if len(nodes) > 1:
                pooled.append((ex, nodes))
            elif not nodes and getattr(ex, "workers", 0) > 1:
                poolless.append(ex)
        if pooled:
            ex, nodes = self.rng.choice(pooled)
            node = ev.node if ev.node in nodes else self.rng.choice(nodes)
            return ex, node
        if poolless:
            return self.rng.choice(poolless), max(0, ev.node)
        return None, -1

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, int]:
        # lazy import: observability consumes this package (alert rows in
        # RunReport), so the constant cannot be imported at module load
        from repro_torch.observability.stream import ALERT_EVENT

        prof = self.engine.profiler
        return {
            "node_failures": sum(1 for i in self.injected
                                 if i["kind"] == "node"),
            "pilot_failures": sum(1 for i in self.injected
                                  if i["kind"] == "pilot"),
            "tasks_killed": sum(i["n_victims"] for i in self.injected),
            "skipped": self.skipped,
            # obs:alert rows any live Watcher recorded during the chaos
            # run — injected faults should surface as streamed alerts
            "alerts_observed": (len(prof.rows_np(ALERT_EVENT))
                                if prof.has_name(ALERT_EVENT) else 0),
        }
