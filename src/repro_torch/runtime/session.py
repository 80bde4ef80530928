"""RADICAL-Pilot-style top-level API: Session -> PilotManager -> TaskManager.

    from repro_torch.runtime import Session, PilotManager, TaskManager
    from repro_torch.core.pilot import PilotDescription
    from repro_torch.core.task import TaskDescription

    with Session(mode="sim", seed=0) as session:        # or mode="real"
        pmgr  = PilotManager(session)
        tmgr  = TaskManager(session)
        pilot = pmgr.submit_pilots(PilotDescription(
            nodes=4, backends={"flux": {"partitions": 2}}))
        tmgr.add_pilots(pilot)
        tasks = tmgr.submit_tasks([TaskDescription(duration=180.0)
                                   for _ in range(100)])
        tmgr.wait_tasks()

The session owns the engine (the pluggable substrate: simulated or real);
pilots wrap resource acquisition in their own state machine (NEW ->
LAUNCHING -> ACTIVE -> DONE) and each ACTIVE pilot runs one Agent; the task
manager routes task submissions to pilot agents and blocks on completion.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

from repro_torch.core.pilot import Pilot, PilotDescription, PilotState
from repro_torch.core.task import (DescriptionBatch, Task, TaskDescription,
                                   new_uid)
from repro_torch.runtime.engine import Engine, RealEngine, SimEngine


class Session:
    """Root object: owns the engine and all managers; ``close()`` (or the
    context manager) tears down pilots, executors, and engine timers."""

    def __init__(self, mode: str = "sim", seed: int = 0,
                 engine: Optional[Engine] = None, uid: str = ""):
        if engine is not None:
            self.engine = engine
        elif mode == "sim":
            self.engine = SimEngine(seed=seed)
        elif mode == "real":
            self.engine = RealEngine(seed=seed)
        else:
            raise KeyError(f"unknown session mode {mode!r}")
        self.uid = uid or new_uid("session")
        self.closed = False
        self._pmgrs: List["PilotManager"] = []
        self._tmgrs: List["TaskManager"] = []
        self.engine.profiler.record(self.engine.now(), self.uid,
                                    "session:start",
                                    {"mode": self.engine.mode})

    @property
    def mode(self) -> str:
        return self.engine.mode

    @property
    def profiler(self):
        return self.engine.profiler

    def pilots(self) -> List[Pilot]:
        return [p for m in self._pmgrs for p in m.pilots]

    def close(self):
        if self.closed:
            return
        self.closed = True
        with self.engine.lock:
            now = self.engine.now()
            for pilot in self.pilots():
                if pilot.state == PilotState.LAUNCHING:
                    pilot.advance(PilotState.CANCELED, now,
                                  self.engine.profiler)
                elif pilot.state == PilotState.ACTIVE:
                    pilot.advance(PilotState.DONE, now, self.engine.profiler)
                agent = getattr(pilot, "agent", None)
                if agent is not None:
                    for ex in agent.backends.values():
                        ex.shutdown()
            self.engine.profiler.record(now, self.uid, "session:close", {})
        self.engine.shutdown()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class PilotManager:
    """Manages pilot lifecycles: ``submit_pilots`` acquires resources
    (constructs the agent over the session engine) and drives the pilot
    state machine; activation is stamped at agent readiness."""

    def __init__(self, session: Session, uid: str = ""):
        self.session = session
        self.uid = uid or new_uid("pmgr")
        self.pilots: List[Pilot] = []
        session._pmgrs.append(self)

    def submit_pilots(self, descriptions: Union[PilotDescription,
                                                Sequence[PilotDescription]],
                      **agent_options) -> Union[Pilot, List[Pilot]]:
        """Launch pilot(s). ``agent_options`` (policy=, speculation=,
        dispatch_rate=, dispatch_batch=, ...) pass through to the Agent."""
        # deferred import: repro_torch.core.agent imports this package at load time
        from repro_torch.core.agent import Agent

        single = isinstance(descriptions, PilotDescription)
        descs = [descriptions] if single else list(descriptions)
        engine = self.session.engine
        out = []
        for pd in descs:
            pilot = Pilot(pd)
            with engine.lock:
                pilot.advance(PilotState.LAUNCHING, engine.now(),
                              engine.profiler)
                agent = Agent(engine, pd.nodes, pd.backends,
                              node_spec=pd.node_spec, **agent_options)
                agent.start()
                pilot.agent = agent
                delay = max(0.0, agent.ready_at - engine.now())
                engine.schedule(delay, self._activate, pilot)
            self.pilots.append(pilot)
            out.append(pilot)
        return out[0] if single else out

    def _activate(self, pilot: Pilot):
        if pilot.state == PilotState.LAUNCHING:
            pilot.advance(PilotState.ACTIVE, self.session.engine.now(),
                          self.session.engine.profiler)

    def cancel_pilots(self, pilots: Optional[Sequence[Pilot]] = None):
        engine = self.session.engine
        with engine.lock:
            for pilot in (pilots if pilots is not None else self.pilots):
                if pilot.state in (PilotState.NEW, PilotState.LAUNCHING,
                                   PilotState.ACTIVE):
                    pilot.advance(PilotState.CANCELED, engine.now(),
                                  engine.profiler)


class TaskManager:
    """Routes task submissions to pilot agents through a campaign
    scheduler (repro_torch.sched) and waits on completion. The default scheduler
    is FIFO passthrough — seed-equivalent least-loaded-pilot bulk
    submission — while ``scheduler=CampaignScheduler(policy=...)`` turns
    on hierarchical scheduling (priority/fair-share ordering, placement
    admission, backfill, gang reservations) for everything this manager
    submits: executables, gangs, funcpool functions, and service
    replicas."""

    def __init__(self, session: Session, uid: str = "",
                 scheduler=None):
        self.session = session
        self.uid = uid or new_uid("tmgr")
        self._pilots: List[Pilot] = []
        self.tasks: Dict[str, Task] = {}
        self._waves: List[Any] = []       # CohortWaves (columnar bulks)
        self._scheduler = scheduler
        session._tmgrs.append(self)

    @property
    def scheduler(self):
        """The campaign scheduler every submission routes through (built
        lazily as FIFO passthrough unless one was injected)."""
        if self._scheduler is None:
            from repro_torch.sched import CampaignScheduler
            self._scheduler = CampaignScheduler()
        return self._scheduler

    def add_pilots(self, pilots: Union[Pilot, Sequence[Pilot]]):
        for p in ([pilots] if isinstance(pilots, Pilot) else list(pilots)):
            if p not in self._pilots:
                self._pilots.append(p)
                self.scheduler.add_pilot(p)

    @property
    def agent(self):
        """The (single) bound pilot's agent — campaign entry point."""
        if len(self._pilots) != 1:
            raise RuntimeError(f"{self.uid}: .agent needs exactly one pilot "
                               f"(have {len(self._pilots)})")
        return self._pilots[0].agent

    def submit_tasks(self, descriptions: Union[TaskDescription,
                                               Sequence[TaskDescription],
                                               DescriptionBatch]
                     ) -> Union[Task, List[Task], Any]:
        if isinstance(descriptions, DescriptionBatch):
            return self.submit_batch(descriptions)
        single = isinstance(descriptions, TaskDescription)
        descs = [descriptions] if single else list(descriptions)
        if self.session.closed:
            raise RuntimeError(f"{self.uid}: session {self.session.uid} "
                               f"is closed")
        if not self._pilots:
            raise RuntimeError(f"{self.uid}: no pilots added")
        # the scheduler owns pilot choice: FIFO passthrough reproduces the
        # seed least-loaded bulk path; gated policies hold tasks in their
        # queue and release on placement (engine.lock is taken inside)
        tasks = self.scheduler.submit(descs)
        if not isinstance(tasks, list):
            # cohort fast path: the bulk stays columnar (a CohortWave) —
            # registering a million per-uid entries would defeat it
            self._waves.append(tasks)
            return tasks
        for t in tasks:
            self.tasks[t.uid] = t
        return tasks[0] if single else tasks

    def submit_batch(self, batch: DescriptionBatch):
        """Submit a columnar :class:`DescriptionBatch` through the campaign
        scheduler: passthrough hands the whole batch to the least-loaded
        pilot (cohort-planned when eligible, bulk object ingestion over
        lazy row views otherwise); gated policies hold it as row-index
        slices and release on placement. Returns a ``CohortWave``, a task
        list, or the scheduler's batch handle — all waitable via
        ``wait_tasks``."""
        if self.session.closed:
            raise RuntimeError(f"{self.uid}: session {self.session.uid} "
                               f"is closed")
        if not self._pilots:
            raise RuntimeError(f"{self.uid}: no pilots added")
        tasks = self.scheduler.submit(batch)
        if not isinstance(tasks, list):
            self._waves.append(tasks)      # CohortWave or _BatchRef (.done)
            return tasks
        for t in tasks:
            self.tasks[t.uid] = t
        return tasks

    def submit_wave(self, template: TaskDescription, n: int):
        """Bulk-submit ``n`` clones of ``template`` as one all-scalar
        :class:`DescriptionBatch` (columnar, O(1) memory per task at
        submit), preferring the cohort fast path. Falls back to object
        tasks over lazy row views when the wave is not cohort-eligible.
        Returns a ``CohortWave`` or list."""
        if n <= 0:
            return []
        return self.submit_batch(DescriptionBatch.from_template(template, n))

    # ------------------------------------------------------------- services
    def start_service(self, handler=None, *, replicas: int = 2,
                      cores: int = 1, gpus: int = 0, nodes: int = 0,
                      startup: float = 0.0, rate: float = 0.0,
                      balancer="round-robin", backend: Optional[str] = None,
                      name: str = "", workflow: str = "",
                      max_retries: int = 2, restart=None, scale=None):
        """Provision ``replicas`` persistent service tasks on the bound
        pilot and return the :class:`repro_torch.services.Service` handle. The
        replica tasks flow through the normal dispatch pipeline and are
        tracked by this manager (``wait_tasks`` covers them); route requests
        with ``service.request(payload)`` / ``submit_requests`` — they are
        buffered until the replicas are READY — and finish with
        ``service.stop()``. The fault model is configured here too:
        ``max_retries`` bounds request requeue on replica death, ``restart``
        takes a :class:`repro_torch.services.RestartPolicy` (replace dead
        replicas), ``scale`` a :class:`repro_torch.services.ScalePolicy` (elastic
        replica count from the queue-depth signal)."""
        from repro_torch.services import Service

        svc = Service(self.agent, handler=handler, replicas=replicas,
                      cores=cores, gpus=gpus, nodes=nodes, startup=startup,
                      rate=rate, balancer=balancer, backend=backend,
                      name=name, workflow=workflow, max_retries=max_retries,
                      restart=restart, scale=scale,
                      submitter=self.scheduler)
        self.submit_tasks(svc.descriptions())
        return svc

    def watch(self, interval: float = 1.0, **watcher_kw):
        """Attach streaming telemetry to the bound pilot's run: returns a
        started :class:`repro_torch.observability.stream.Watcher` whose
        engine callback folds the trace every ``interval`` (virtual seconds
        on a sim session, wall seconds on a real one). Keyword args pass
        through — ``rules=``, ``services=``, ``emit=``, ``promfile=``,
        ``on_tick=``, ``dt=``. Works on both engines; the watcher
        auto-finalizes when the agent drains."""
        # deferred import: observability is an optional consumer layer
        from repro_torch.observability.stream import Watcher

        return Watcher(self.agent, interval=interval, **watcher_kw).start()

    def submit_functions(self, fn, argslist, **td_kw) -> List[Task]:
        """Submit one function task per element of ``argslist`` (each element
        becomes the positional args; non-tuples are wrapped). With a
        ``funcpool`` backend configured these execute inside persistent
        workers — the paper's high-throughput function path."""
        descs = [TaskDescription(kind="function", fn=fn,
                                 args=a if isinstance(a, tuple) else (a,),
                                 **td_kw)
                 for a in argslist]
        return self.submit_tasks(descs)

    def wait_tasks(self, tasks: Optional[Sequence[Task]] = None,
                   timeout: Optional[float] = None) -> bool:
        """Block until the given tasks (default: all submitted through this
        manager) reach a terminal state. Sim engines drain their event heap;
        real engines wait on wall-clock completion."""
        watched = list(tasks) if tasks is not None else None

        def finished() -> bool:
            if watched is not None:
                return all(t.done for t in watched)
            return (all(w.done for w in self._waves)
                    and all(t.done for t in self.tasks.values()))

        return self.session.engine.drain(finished, timeout=timeout)

    def run_campaign(self, stages, name: str = "campaign",
                     timeout: Optional[float] = None):
        """Convenience: run a Campaign through this manager's scheduler
        (stage priorities/tenants and ``barrier=False`` per-task release
        apply) and block until it completes. Returns the Campaign."""
        from repro_torch.core.campaign import Campaign

        sched = self.scheduler
        camp = Campaign(sched, stages, name=name)
        with self.session.engine.lock:
            camp.start()
        self.session.engine.drain(
            lambda: sched.n_unfinished == 0 and camp.complete,
            timeout=timeout)
        return camp
