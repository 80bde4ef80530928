"""Workflow-of-workflows engine: stages with dependencies, adaptive task
generation from runtime feedback (idle-resource polling), per-stage metrics.
This is the layer the IMPECCABLE campaign (§2) runs on.

A campaign submits to a *target*: either an
:class:`~repro_torch.core.agent.Agent` (direct, seed behavior) or a :class:`repro_torch.sched.CampaignScheduler`
(hierarchical scheduling: stage priorities/tenants order the queue, and
``barrier=False`` stages release per task — each task enters the scheduler
queue as its individual upstreams finish instead of waiting for the whole
upstream stage, removing barriers the paper's workflows don't have).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.agent import Agent
from repro_torch.core.task import (DescriptionBatch, Task, TaskDescription,
                                   TaskState)


@dataclass
class Stage:
    """``make_tasks(ctx)`` is called when all dependencies completed; it may
    inspect ``ctx`` (agent, free resources, previous-stage results) to size
    the workload adaptively (§4.2: "the number of tasks instantiated by some
    workflows is adjusted dynamically at runtime"). It may return a
    ``List[TaskDescription]`` or a columnar
    :class:`~repro_torch.core.task.DescriptionBatch` — stage stamping and
    dependency wiring then operate on whole columns instead of per object.

    ``priority``/``tenant`` stamp every task the stage creates (scheduler
    ordering classes / fair-share accounts). ``barrier=False`` launches the
    stage as soon as its upstream stages have *launched* — its tasks carry
    per-task ``after`` dependencies (auto-wired 1:1 against a single
    same-sized upstream stage, else against all upstream tasks) and are
    released by the scheduler as those upstreams finish individually."""
    name: str
    make_tasks: Callable[["StageContext"], List[TaskDescription]]
    depends_on: Sequence[str] = ()
    workflow: str = ""
    priority: int = 0
    tenant: str = ""
    barrier: bool = True


@dataclass
class StageContext:
    agent: Agent
    campaign: "Campaign"
    stage: Stage

    @property
    def free_cores(self) -> int:
        # spans every pilot when the campaign targets a scheduler
        return self.campaign.target.free_cores

    def results(self, stage_name: str) -> List[Task]:
        return self.campaign.stage_tasks.get(stage_name, [])


class Campaign:
    def __init__(self, target, stages: Sequence[Stage],
                 name: str = "campaign"):
        self.target = target
        # ctx.agent compatibility: stages that build Services or inspect
        # backends get the primary agent even under a scheduler target
        agents = getattr(target, "agents", None)
        self.agent: Agent = agents[0] if agents else target
        self.name = name
        self.stages = {s.name: s for s in stages}
        if (any(not s.barrier for s in stages)
                and not getattr(target, "supports_deps", False)):
            raise ValueError(
                f"{name}: barrier=False stages need a CampaignScheduler "
                f"target (per-task `after` dependencies are released by "
                f"the scheduler, not by a bare Agent)")
        self._waiting: Dict[str, set] = {
            s.name: set(s.depends_on) for s in stages}
        self.stage_tasks: Dict[str, List[Task]] = {}
        self._stage_pending: Dict[str, int] = {}
        self._launched: set = set()
        self._done_stages: set = set()
        self._started = False
        # register (not assign): previously this clobbered any installed
        # on_task_done, so campaigns didn't compose with other watchers
        # (service readiness, user callbacks) on the same agent
        target.add_done_callback(self._task_done)

    @property
    def engine(self):
        return self.target.engine

    # ------------------------------------------------------------------ run
    def start(self):
        assert not self._started
        self._started = True
        self.engine.profiler.record(self.engine.now(), self.name,
                                    "campaign:start", {})
        for name, deps in list(self._waiting.items()):
            if not deps:
                self._launch_stage(name)

    def _launch_stage(self, name: str):
        if name in self._launched:
            return
        self._launched.add(name)
        stage = self.stages[name]
        ctx = StageContext(self.agent, self, stage)
        descs = stage.make_tasks(ctx)
        if isinstance(descs, DescriptionBatch):
            self._stamp_batch(stage, name, descs)
        else:
            for d in descs:
                d.stage = name
                d.workflow = stage.workflow or name
                if stage.priority and not d.priority:
                    d.priority = stage.priority
                if stage.tenant and not d.tenant:
                    d.tenant = stage.tenant
        if not stage.barrier:
            self._wire_task_deps(stage, descs)
        self.engine.profiler.record(
            self.engine.now(), name, "stage:start",
            {"tasks": len(descs)})
        if not descs:
            self._stage_complete(name)
            # an empty stage still counts as launched: downstream
            # barrier-free stages must not silently fall back to waiting
            # on full completion of their other upstreams
            self._release_nonbarrier_stages()
            return
        self._stage_pending[name] = len(descs)
        self.stage_tasks[name] = self.target.submit(descs)
        # stages downstream of this one that opted out of the barrier can
        # launch now — their tasks hold on per-task `after` dependencies
        self._release_nonbarrier_stages()

    def _stamp_batch(self, stage: Stage, name: str,
                     batch: DescriptionBatch):
        """Columnar equivalent of the per-description stage stamping:
        stage/workflow overwrite whole columns; priority/tenant fill only
        rows still at their defaults (same keep-explicit semantics as the
        object path)."""
        sentinel = object()
        batch.set_column("stage", name)
        batch.set_column("workflow", stage.workflow or name)
        if stage.priority:
            v = batch.scalar("priority", sentinel)
            if v is sentinel:
                col = batch.col("priority")
                mask = col == 0
                if mask.any():
                    col = col.copy()
                    col[mask] = stage.priority
                    batch.set_column("priority", col)
            elif not v:
                batch.set_column("priority", stage.priority)
        if stage.tenant:
            v = batch.scalar("tenant", sentinel)
            if v is sentinel:
                codes, pool = batch.str_codes("tenant")
                if "" in pool:
                    batch.set_column(
                        "tenant", [pool[c] or stage.tenant
                                   for c in codes.tolist()])
            elif not v:
                batch.set_column("tenant", stage.tenant)

    @staticmethod
    def _stage_uids(tasks) -> List[str]:
        """Uids of one submitted stage, whatever shape the submission
        returned: a task list, a columnar batch handle (uids come from the
        batch — materialization state is irrelevant), or a cohort wave."""
        batch = getattr(tasks, "batch", None)
        if batch is not None:
            return [batch.uid(i) for i in range(batch.n)]
        return [t.uid for t in tasks]

    def _wire_task_deps(self, stage: Stage, descs):
        """Default ``after`` wiring for a barrier-free stage: 1:1 against a
        single same-sized upstream stage (the map-over-upstream pattern),
        otherwise each task waits on every upstream task. Descriptions
        with explicit ``after`` keep it. Batch stages write into the
        sparse ``after`` column row by row."""
        upstream = [self.stage_tasks.get(dep, [])
                    for dep in stage.depends_on]
        one_to_one = (len(upstream) == 1
                      and len(upstream[0]) == len(descs))
        up_uids = ([self._stage_uids(upstream[0])] if one_to_one
                   else [self._stage_uids(ts) for ts in upstream])
        all_uids = (() if one_to_one
                    else tuple(u for us in up_uids for u in us))
        if isinstance(descs, DescriptionBatch):
            for i in range(descs.n):
                if descs.get("after", i):
                    continue
                descs.set_sparse("after", i,
                                 (up_uids[0][i],) if one_to_one
                                 else all_uids)
            return
        for i, d in enumerate(descs):
            if d.after:
                continue
            d.after = ((up_uids[0][i],) if one_to_one else all_uids)

    def _release_nonbarrier_stages(self):
        for other, stage in self.stages.items():
            if (other in self._launched or stage.barrier
                    or not all(dep in self._launched
                               for dep in stage.depends_on)):
                continue
            self._launch_stage(other)

    def _task_done(self, task: Task):
        stage = task.description.stage
        if stage not in self._stage_pending:
            return
        self._stage_pending[stage] -= 1
        if self._stage_pending[stage] == 0:
            # elastic services outlive their original replica set: restart
            # replacements and scale-ups are resubmitted internally (not
            # stage tasks), so hold the stage open until *every* service
            # owning one of its tasks has fully shut down — the last task
            # to finish need not belong to the still-live service
            services = {}
            for t in self.stage_tasks.get(stage, []):
                svc = t.description.service
                if svc is not None:
                    services[id(svc)] = svc
            waiting = [svc for svc in services.values() if not svc.stopped]
            if waiting:
                remaining = {"n": len(waiting)}

                def one_stopped(s=stage, remaining=remaining):
                    remaining["n"] -= 1
                    if remaining["n"] == 0:
                        self._stage_complete(s)

                for svc in waiting:
                    svc.on_stopped(one_stopped)
            else:
                self._stage_complete(stage)

    def _stage_complete(self, name: str):
        if name in self._done_stages:
            return
        self._done_stages.add(name)
        self.engine.profiler.record(self.engine.now(), name,
                                    "stage:done", {})
        for other, deps in self._waiting.items():
            if name in deps:
                deps.discard(name)
                if not deps:
                    self._launch_stage(other)

    @property
    def complete(self) -> bool:
        return len(self._done_stages) == len(self.stages)

    def all_tasks(self) -> List[Task]:
        return [t for ts in self.stage_tasks.values() for t in ts]
