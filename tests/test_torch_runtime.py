"""The port's task runtime (``repro_torch.core``, ``runtime``, ``sched``,
``services``) against the JAX package's (``repro.*``), on the CPU.

* The same seed gives the same simulated run in both packages: every
  workload below runs through ``Session(mode="sim", seed=s)`` of each, and
  the profiler's event columns (time, entity, name), every task's final
  state and timestamps and a service's request log must be equal, exactly:
  the code, the calibration and the draws are the same.
* Real-mode twins of the JAX package's tests
  (tests/test_runtime_substrate.py, tests/test_faults.py) on the port's
  runtime. These twins order stages by ``after`` dependencies and inject
  faults through the scheduler's and the executors' own hooks, which is
  what ``Campaign`` and ``ChaosController`` call; the twins through those
  two are in tests/test_torch_runtime_substrate.py and
  tests/test_torch_faults.py.
* The partition bridge: a one-process ``Mesh`` is one partition and reaches
  a callable that declares ``mesh=``; a mesh over several ranks raises.
* The kernel wrappers' launch counts lose nothing under threads.
"""
import importlib
import itertools
import sys
import threading
import time

import numpy as np
import pytest
import torch

PKGS = ("repro", "repro_torch")


class Pkg:
    """One package's runtime surface, by module path."""

    def __init__(self, name):
        self.name = name
        rt = importlib.import_module(f"{name}.runtime")
        self.Session = rt.Session
        self.PilotManager = rt.PilotManager
        self.TaskManager = rt.TaskManager
        self.task = importlib.import_module(f"{name}.core.task")
        self.TD = self.task.TaskDescription
        self.PD = importlib.import_module(f"{name}.core.pilot").PilotDescription
        sched = importlib.import_module(f"{name}.sched")
        self.CampaignScheduler = sched.CampaignScheduler
        self.PriorityPolicy = sched.PriorityPolicy
        self.FairSharePolicy = sched.FairSharePolicy
        services = importlib.import_module(f"{name}.services")
        self.RestartPolicy = services.RestartPolicy
        self.ScalePolicy = services.ScalePolicy


def _uid_start(pkgs):
    """A uid count past both packages' counters: each run starts its
    package's counter there, so both traces name the same entities and no
    uid of this process repeats."""
    return max(next(p.task._uid_counter) for p in pkgs)


# ------------------------------------------------------------ sim workloads
def _pilot(p, s, nodes, backends, sched=None, **agent_kw):
    pilot = p.PilotManager(s).submit_pilots(
        p.PD(nodes=nodes, backends=backends), **agent_kw)
    tmgr = p.TaskManager(s, scheduler=sched)
    tmgr.add_pilots(pilot)
    return pilot, tmgr


def w_dragon_functions(p, s):
    _, tm = _pilot(p, s, 2, {"dragon": {}})
    wave = tm.submit_tasks([p.TD(kind="function", duration=0.5)
                            for _ in range(200)])
    mixed = tm.submit_tasks([p.TD(kind="function", cores=1 + i % 2,
                                  duration=0.1 * (1 + i % 7))
                             for i in range(60)])
    assert tm.wait_tasks(timeout=60)
    return list(wave) + list(mixed), {}


def w_funcpool_functions(p, s):
    _, tm = _pilot(p, s, 1, {"funcpool": {"workers": 4}})
    tasks = tm.submit_tasks([p.TD(kind="function", duration=0.01 * (1 + i % 5))
                             for i in range(300)])
    assert tm.wait_tasks(timeout=60)
    return list(tasks), {}


def w_flux_executables(p, s):
    _, tm = _pilot(p, s, 4, {"flux": {"partitions": 2}})
    tasks = tm.submit_tasks(
        [p.TD(cores=1 + i % 4, duration=5.0 + i % 3) for i in range(150)]
        + [p.TD(nodes=1, duration=8.0, coupling="tight") for _ in range(3)])
    assert tm.wait_tasks(timeout=60)
    return list(tasks), {}


def w_srun_executables(p, s):
    _, tm = _pilot(p, s, 2, {"srun": {}})
    tasks = tm.submit_tasks([p.TD(cores=1 + i % 8, duration=3.0 + i % 4)
                             for i in range(120)])
    assert tm.wait_tasks(timeout=60)
    return list(tasks), {}


def w_sched_priority_fair_share(p, s):
    sched = p.CampaignScheduler(policy=p.PriorityPolicy(aging_rate=0.5),
                                admission=True)
    _, tm = _pilot(p, s, 2, {"flux": {"partitions": 1}}, sched)
    tasks = tm.submit_tasks(
        [p.TD(cores=56, duration=10.0, priority=i % 3) for i in range(12)])
    fair = p.CampaignScheduler(policy=p.FairSharePolicy(), admission=True)
    _, tm2 = _pilot(p, s, 2, {"flux": {"partitions": 1}}, fair)
    tasks2 = tm2.submit_tasks(
        [p.TD(cores=8, duration=20.0, tenant="a", share=3.0)
         for _ in range(30)]
        + [p.TD(cores=8, duration=20.0, tenant="b", share=1.0)
           for _ in range(30)])
    assert tm.wait_tasks(timeout=60) and tm2.wait_tasks(timeout=60)
    return list(tasks) + list(tasks2), {}


def w_service(p, s):
    _, tm = _pilot(p, s, 8, {"flux": {"partitions": 2}})
    svc = tm.start_service(replicas=2, nodes=1, startup=5.0, rate=2.0,
                           balancer="least-outstanding")
    svc.submit_requests(range(40))
    svc.stop()
    assert tm.wait_tasks(timeout=60)
    assert svc.stopped and svc.n_completed == 40
    log = {k: list(v) for k, v in svc.request_log().items()}
    return list(tm.tasks.values()), {"request_log": log}


def w_retry(p, s):
    # walltime 12 under a 30 s payload with checkpoints every 5: killed
    # twice, retried from its banked progress, then done; and one without
    # checkpoints that exhausts its retries
    _, tm = _pilot(p, s, 2, {"flux": {"partitions": 1}}, retry_backoff=1.0,
                   retry_jitter=0.5)
    tasks = tm.submit_tasks(
        [p.TD(cores=4, duration=30.0, walltime=12.0, max_retries=3,
              checkpoint_dir="ckpt://t0", checkpoint_period=5.0),
         p.TD(cores=4, duration=30.0, walltime=5.0, max_retries=2)])
    assert tm.wait_tasks(timeout=60)
    return list(tasks), {}


def w_node_loss_dag(p, s):
    sched = p.CampaignScheduler(policy="fifo", admission=True)
    pilot, tm = _pilot(p, s, 6, {"flux": {"partitions": 2}}, sched,
                       retry_backoff=1.0)
    head = [p.TD(cores=28, duration=20.0, max_retries=4, uid=f"fa.{i}")
            for i in range(8)]
    gang = p.TD(nodes=2, duration=10.0, max_retries=4, uid="fgang",
                after=tuple(d.uid for d in head))
    tail = p.TD(cores=1, duration=2.0, max_retries=4, uid="ftail",
                after=("fgang",))
    eng = s.engine

    def lose_node():
        with eng.lock:
            ex = pilot.agent.backends["flux"]
            nodes = sorted(ex.live_nodes())
            node = nodes[len(nodes) // 2]
            assert ex.fail_node(node, "node failure") is not None
            sched.on_node_failure(0, node)

    eng.schedule(5.0, lose_node)
    eng.schedule(7.0, lose_node)
    tasks = tm.submit_tasks(head + [gang, tail])
    assert tm.wait_tasks(timeout=60)
    return list(tasks), {}


def w_cohort_wave(p, s):
    # tests/test_cohort_golden.py's hybrid wave, cut to 600 tasks: a
    # cohort_min below the wave (the agent's default is 50,000) lets the
    # planner take it, one cohort per backend
    pilot, tm = _pilot(p, s, 8, {"flux": {"nodes": 4, "partitions": 2},
                                 "dragon": {"nodes": 4, "partitions": 2}},
                       cohort=True, cohort_min=500)
    wave = tm.submit_tasks(
        [p.TD(kind="function" if i % 2 else "executable", cores=2,
              duration=0.05 * (i % 4)) for i in range(600)])
    assert tm.wait_tasks(timeout=60)
    assert isinstance(wave, p.task.CohortWave)
    assert len(pilot.agent.cohorts) == 2
    return list(wave), {}


def w_batch_and_wave(p, s):
    # tests/test_batch_golden.py's paths: a uniform wave of one template
    # through submit_wave, which the cohort planner takes (it plans only on
    # idle executors), then a mixed DescriptionBatch (dense columns,
    # interned strings, explicit uids) through submit_batch beside it; and
    # a batch held as row slices by a gated priority scheduler on a second
    # pilot
    def mixed(tag):
        return p.task.DescriptionBatch.from_descriptions(
            [p.TD(uid=f"{tag}.{i}",
                  kind="function" if i % 3 == 0 else "executable",
                  cores=1 + i % 4, duration=0.5 * (1 + i % 5),
                  priority=i % 3, tenant="ab"[i % 2]) for i in range(240)])

    backends = {"flux": {"partitions": 2}, "dragon": {"partitions": 2}}
    pilot, tm = _pilot(p, s, 4, backends, cohort=True, cohort_min=300)
    wave = tm.submit_wave(p.TD(cores=1, duration=0.25), 400)
    tm.submit_batch(mixed("b"))
    sched = p.CampaignScheduler(policy=p.PriorityPolicy(), admission=True)
    gated_pilot, tm2 = _pilot(p, s, 4, backends, sched)
    tm2.submit_batch(mixed("g"))
    assert tm.wait_tasks(timeout=60) and tm2.wait_tasks(timeout=60)
    assert isinstance(wave, p.task.CohortWave)
    tasks = (list(pilot.agent.tasks.values()) + list(wave)
             + list(gated_pilot.agent.tasks.values()))
    assert len(tasks) == 880
    return tasks, {}


def w_speculation(p, s):
    # tests/test_runtime_core.py's straggler: the first task launched runs
    # 10x its duration and a speculative clone finishes first
    straggler = {}

    def duration_fn(task):
        straggler.setdefault("uid", task.uid)
        scale = 10.0 if task.uid == straggler["uid"] else 1.0
        return task.description.duration * scale

    s.engine.duration_fn = duration_fn
    pilot, tm = _pilot(p, s, 8, {"flux": {"partitions": 2}},
                       speculation=True, speculation_factor=2.0)
    tm.submit_tasks([p.TD(cores=1, duration=30.0) for _ in range(40)])
    assert tm.wait_tasks(timeout=60)
    tasks = list(pilot.agent.tasks.values())
    assert any(t.speculative_of for t in tasks)
    return tasks, {}


def w_elastic_service(p, s):
    # tests/test_service_faults.py's chaos and autoscaling paths in one
    # service: a replica killed mid-stream (its requests requeue, a
    # RestartPolicy replaces it) under a ScalePolicy that grows the
    # rotation for the burst and drains it after
    _, tm = _pilot(p, s, 16, {"flux": {"partitions": 8}})
    svc = tm.start_service(
        replicas=2, nodes=1, startup=0.5, rate=1.0, max_retries=3,
        balancer="least-outstanding",
        restart=p.RestartPolicy(max_restarts=2, backoff=0.5),
        scale=p.ScalePolicy(min_replicas=2, max_replicas=5, up_threshold=3.0,
                            down_threshold=0.5, cooldown=2.0))
    eng, t0 = s.engine, 30.0
    for i in range(120):
        eng.schedule(t0 + i * 0.125, svc.request, i)
    eng.schedule(t0 + 4.0, svc.kill_replica)
    eng.schedule(t0 + 120 * 0.125 + 40.0, svc.stop)
    assert svc.wait_stopped()
    assert svc.n_completed == 120 and svc.restarts >= 1
    log = {k: list(v) for k, v in svc.request_log().items()}
    scale = {k: list(v) for k, v in svc.scale_log().items()}
    assert scale["t"], "the service never scaled"
    return list(tm.tasks.values()), {"request_log": log, "scale_log": scale}


WORKLOADS = {f.__name__[2:]: f for f in (
    w_dragon_functions, w_funcpool_functions, w_flux_executables,
    w_srun_executables, w_sched_priority_fair_share, w_service, w_retry,
    w_node_loss_dag, w_cohort_wave, w_batch_and_wave, w_speculation,
    w_elastic_service)}


def _sim_run(p, workload, seed):
    with p.Session(mode="sim", seed=seed) as s:
        tasks, extra = WORKLOADS[workload](p, s)
    trace = [(e.time, e.entity, e.name) for e in s.profiler.events]
    rows = sorted((t.uid, t.state.value, dict(t.timestamps)) for t in tasks)
    return trace, rows, extra


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_same_seed_same_trace_in_both_packages(workload, seed):
    pkgs = [Pkg(n) for n in PKGS]
    start = _uid_start(pkgs)
    runs = []
    for p in pkgs:
        p.task._uid_counter = itertools.count(start)
        runs.append(_sim_run(p, workload, seed))
    want, got = runs
    assert len(want[0]) > 0 and len(want[1]) > 0
    assert got[0] == want[0], "trace columns (time, entity, name) differ"
    assert got[1] == want[1], "task states or timestamps differ"
    assert got[2] == want[2], "request log differs"


# ----------------------------------------------- real-mode twins (the port)
from repro_torch.core.executors.base import BaseExecutor  # noqa: E402
from repro_torch.core.pilot import PilotDescription, PilotState  # noqa: E402
from repro_torch.core.task import TaskDescription, TaskState  # noqa: E402
from repro_torch.runtime import (PilotManager, Session,  # noqa: E402
                                 TaskManager, available_executors)
from repro_torch.sched import CampaignScheduler  # noqa: E402


def _dag(square):
    """tests/test_runtime_substrate.py's diamond campaign (prepare -> train,
    score -> select) as descriptions whose ``after`` names the upstream
    stages' uids; each carries a sim duration and a real payload."""
    def mk(n, kind, tag, after=()):
        return [TaskDescription(kind=kind, cores=1, duration=0.5, fn=square,
                                args=(i,), workflow=tag, after=after,
                                uid=f"{tag}.{i}")
                for i in range(n)]

    prepare = mk(4, "function", "prepare")
    up = tuple(d.uid for d in prepare)
    train = mk(2, "executable", "train", up)
    score = mk(3, "function", "score", up)
    select = mk(1, "function", "select",
                tuple(d.uid for d in train + score))
    return {"prepare": prepare, "train": train, "score": score,
            "select": select}


def _run_dag(mode):
    with Session(mode=mode, seed=0) as session:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=4, backends={"flux": {"partitions": 2}, "dragon": {}}))
        tmgr = TaskManager(session, scheduler=CampaignScheduler(
            policy="fifo", admission=True))
        tmgr.add_pilots(pilot)
        stages = _dag(lambda x: x * x)
        tasks = tmgr.submit_tasks([d for ds in stages.values() for d in ds])
        assert tmgr.wait_tasks(timeout=120)
        by_uid = {t.uid: t for t in tasks}
        return ({k: [by_uid[d.uid] for d in ds] for k, ds in stages.items()},
                pilot)


def test_dag_identical_across_engines():
    """Twin of test_campaign_identical_across_engines: one definition on
    both engines of the port, the same per-stage counts, terminal states
    and payload results, and dependents start after their upstreams."""
    sim, _ = _run_dag("sim")
    real, pilot = _run_dag("real")
    assert pilot.state == PilotState.DONE
    assert set(sim) == set(real)
    for name in sim:
        s, r = sim[name], real[name]
        assert len(s) == len(r), name
        assert ([t.state for t in s] == [t.state for t in r]
                == [TaskState.DONE] * len(s)), name
    assert sorted(t.result for t in real["prepare"]) == [0, 1, 4, 9]
    for run in (sim, real):
        done = {k: max(t.timestamps["DONE"] for t in v)
                for k, v in run.items()}
        start = {k: min(t.timestamps["RUNNING"] for t in v)
                 for k, v in run.items()}
        assert start["train"] >= done["prepare"]
        assert start["score"] >= done["prepare"]
        assert start["select"] >= max(done["train"], done["score"])


def test_run_campaign_and_watch_name_their_roadmap_items():
    """``run_campaign`` and ``watch`` run in the port (they raised, naming
    their ROADMAP items, until their modules were ported): a two-stage
    campaign under a watcher, and the watcher's streamed breakdown equal to
    the post-hoc one at finalize."""
    from repro_torch.core.campaign import Stage
    from repro_torch.observability.lifecycle import lifecycle_breakdown

    with Session(mode="sim", seed=0) as session:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=2, backends={"flux": {"partitions": 1}, "dragon": {}}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)
        watcher = tmgr.watch(interval=1.0)
        camp = tmgr.run_campaign([
            Stage("a", lambda ctx: [TaskDescription(cores=1, duration=2.0)
                                    for _ in range(6)]),
            Stage("b", lambda ctx: [TaskDescription(kind="function",
                                                    duration=1.0)],
                  depends_on=["a"])])
        assert camp.complete
        assert [len(camp.stage_tasks[k]) for k in "ab"] == [6, 1]
        watcher.finalize()
        got = watcher.breakdown.stats(exact_quantiles=True)
        want = lifecycle_breakdown(pilot.agent.all_tasks(),
                                   session.profiler).total.as_dict()
        assert got["n"] == want["n"] == 7
        for phase, stats in want["phases"].items():
            assert got["phases"][phase]["n"] == stats["n"], phase
            assert got["phases"][phase]["sum"] == pytest.approx(
                stats["sum"], rel=1e-9, abs=1e-12), phase


def test_subprocess_executor_runs_executables():
    with Session(mode="real") as session:
        pmgr, tmgr = PilotManager(session), TaskManager(session)
        pilot = pmgr.submit_pilots(PilotDescription(
            nodes=1, backends={"popen": {}, "dragon": {}}))
        tmgr.add_pilots(pilot)
        ok = tmgr.submit_tasks(TaskDescription(
            kind="executable", executable="echo", arguments=("hello", 42)))
        bad = tmgr.submit_tasks(TaskDescription(
            kind="executable", executable="false", max_retries=1))
        assert tmgr.wait_tasks(timeout=60)
        assert ok.state == TaskState.DONE and ok.result.strip() == "hello 42"
        assert ok.backend == "popen"
        assert bad.state == TaskState.FAILED and bad.retries == 1


def test_real_engine_retries_through_agent_pipeline():
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    with Session(mode="real") as session:
        pmgr, tmgr = PilotManager(session), TaskManager(session)
        pilot = pmgr.submit_pilots(PilotDescription(
            nodes=1, backends={"dragon": {"workers": 1}}))
        tmgr.add_pilots(pilot)
        task = tmgr.submit_tasks(TaskDescription(
            kind="function", fn=flaky, max_retries=3))
        assert tmgr.wait_tasks(timeout=60)
        assert task.state == TaskState.DONE and task.result == "ok"
        assert len(session.profiler.by_name("agent:retry")) == 2


def test_session_pilot_state_machine():
    session = Session(mode="sim")
    pmgr = PilotManager(session)
    pilot = pmgr.submit_pilots(PilotDescription(nodes=2))
    assert pilot.state == PilotState.LAUNCHING     # clock not yet run
    session.engine.drain()
    assert pilot.state == PilotState.ACTIVE
    assert pilot.timestamps["ACTIVE"] >= pilot.agent.ready_at
    session.close()
    assert pilot.state == PilotState.DONE


def test_registry_names_the_ports_backends():
    assert available_executors("sim") == ["dragon", "flux", "funcpool",
                                          "srun"]
    assert available_executors("real") == ["dragon", "flux", "funcpool",
                                           "popen"]
    assert all(issubclass(type(ex), BaseExecutor)
               for ex in _backends_of_a_real_pilot().values())


def _backends_of_a_real_pilot():
    with Session(mode="real") as session:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=1, backends={"dragon": {}, "flux": {}, "popen": {}}))
        return dict(pilot.agent.backends)


def test_real_walltime_kills_hung_task():
    with Session(mode="real", seed=0) as session:
        pilot = PilotManager(session).submit_pilots(
            PilotDescription(nodes=1, backends={"dragon": {"workers": 2}}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)
        task = tmgr.submit_tasks(TaskDescription(
            kind="function", fn=lambda: time.sleep(5.0), walltime=0.25))
        assert tmgr.wait_tasks(timeout=10)
        assert task.state is TaskState.FAILED
        assert "walltime exceeded" in task.error
        assert len(session.profiler.by_name("task:walltime")) == 1


def test_real_node_loss_mid_dag():
    with Session(mode="real", seed=0) as session:
        pilot = PilotManager(session).submit_pilots(
            PilotDescription(nodes=2, backends={"flux": {"partitions": 4}}),
            retry_backoff=0.05)
        sched = CampaignScheduler(policy="fifo", admission=True)
        tmgr = TaskManager(session, scheduler=sched)
        tmgr.add_pilots(pilot)
        head = [TaskDescription(kind="function",
                                fn=lambda: time.sleep(0.05) or "ok",
                                max_retries=3, uid=f"rh.{i}")
                for i in range(8)]
        tail = TaskDescription(kind="function", fn=lambda: "tail",
                               max_retries=3, uid="rtail",
                               after=tuple(d.uid for d in head))
        eng, lost = session.engine, []

        def lose_node():
            # what the chaos controller does for a pool-less real backend
            with eng.lock:
                lost.append(pilot.agent.backends["flux"].fail_node(
                    0, "node failure"))
                sched.on_node_failure(0, 0)

        eng.schedule(0.06, lose_node)
        tasks = tmgr.submit_tasks(head + [tail])
        assert tmgr.wait_tasks(timeout=30)
        assert all(t.state is TaskState.DONE for t in tasks)
        assert len(lost) == 1 and lost[0] is not None
        assert pilot.agent.backends["flux"].workers == 3
        assert len(session.profiler.by_name("sched:view_shrink")) == 1


def test_real_pilot_failure_requeues_to_survivor():
    with Session(mode="real", seed=0) as session:
        pilots = PilotManager(session).submit_pilots(
            [PilotDescription(nodes=1, backends={"dragon": {"workers": 2}}),
             PilotDescription(nodes=1,
                              backends={"dragon": {"workers": 2}})])
        sched = CampaignScheduler(policy="fifo", admission=False)
        tmgr = TaskManager(session, scheduler=sched)
        tmgr.add_pilots(pilots)
        eng = session.engine
        eng.schedule(0.15, lambda: sched.fail_pilot(0))
        tasks = tmgr.submit_tasks(
            [TaskDescription(kind="function",
                             fn=lambda x=i: time.sleep(0.02) or x)
             for i in range(30)])
        assert tmgr.wait_tasks(timeout=30)
        assert all(t.state is TaskState.DONE for t in tasks)
        assert sorted(t.result for t in tasks) == list(range(30))
        assert pilots[0].state is PilotState.FAILED


def test_real_checkpoint_resume_contract(tmp_path):
    """A crashing training task resumes from its latest checkpoint on retry:
    the runtime injects the port's CheckpointManager and the resume step;
    the resumed run ends equal, bit for bit, to an uninterrupted one; and
    the JAX package's manager reads the checkpoint back."""
    from repro.checkpoint.checkpoint import CheckpointManager as JManager
    from repro_torch import tree as T
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.train_step import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    cfg = get_smoke_config("mamba2-130m", dtype="float32")
    step = make_train_step(cfg, adamw.OptimizerConfig(warmup_steps=1,
                                                      total_steps=10))
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "positions": torch.arange(16).expand(2, 16)}
    seen = []

    def trainer(n_steps, checkpoint=None, resume_from=None):
        seen.append(resume_from)
        params = M.init_params(cfg, seed=0, device="cpu")
        opt = adamw.init(params)
        start = 0
        if resume_from is not None:
            tree = checkpoint.restore(resume_from, template={
                "params": params, "opt": opt})["tree"]
            params, opt, start = tree["params"], tree["opt"], resume_from + 1
        for s in range(start, n_steps):
            params, opt, _ = step(params, opt, batch)
            if checkpoint is not None and s % 2 == 0:
                checkpoint.save(s, {"params": params, "opt": opt})
            if checkpoint is not None and s == 4 and resume_from is None:
                raise RuntimeError("simulated crash after step 4")
        return params

    want = trainer(6)
    seen.clear()
    with Session(mode="real", seed=0) as session:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=1, backends={"flux": {"partitions": 1}}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)
        task = tmgr.submit_tasks(TaskDescription(
            kind="executable", fn=trainer, args=(6,), max_retries=1,
            checkpoint_dir=str(tmp_path / "ckpt")))
        assert tmgr.wait_tasks(timeout=120)
        assert task.state is TaskState.DONE and task.backend == "flux"
        assert seen == [None, 4]
        resumes = session.profiler.by_name("task:resume")
        assert len(resumes) == 1 and resumes[0].data["progress"] == 4
    for (key, got), (_, w) in zip(T.flatten(task.result), T.flatten(want)):
        assert torch.equal(got, w), key
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 4
    out = JManager(str(tmp_path / "ckpt")).restore()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    ours = mgr.restore(4)
    assert out["step"] == 4
    for key, _ in T.flatten({"params": want, "opt": adamw.init(want)}):
        np.testing.assert_array_equal(np.asarray(out["get"](key)),
                                      ours["get"](key).numpy(), err_msg=key)


# ------------------------------------------------------- partition bridge
def test_one_process_mesh_is_one_partition_and_reaches_mesh_callables():
    from repro_torch.core.partition import carve_submeshes
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")
    parts = carve_submeshes(mesh, 4)
    assert len(parts) == 1 and parts[0].index == 0 and parts[0].mesh is mesh
    with pytest.raises(ValueError):
        carve_submeshes(mesh, 1, axis="pipeline")
    with Session(mode="real") as session:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=1, backends={"flux": {"partitions": 2, "mesh": mesh}}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)
        task = tmgr.submit_tasks(TaskDescription(
            kind="executable", coupling="tight",
            fn=lambda mesh=None: (mesh.shape, mesh.size)))
        assert tmgr.wait_tasks(timeout=30)
        assert task.state is TaskState.DONE
        assert task.result == ({"data": 1, "model": 1}, 1)
        assert task.partition == 0


def test_multi_rank_mesh_carve_names_item_12b():
    from repro_torch.core.partition import carve_submeshes
    from repro_torch.launch.mesh import abstract_mesh

    with pytest.raises(NotImplementedError, match="12b"):
        carve_submeshes(abstract_mesh(data=4, model=1), 2)


# ---------------------------------------------------------- launch counts
def test_launch_counts_lose_nothing_under_threads():
    """Several threads count launches of one wrapper at once, with the
    interpreter switching threads as often as it can: none is lost."""
    from repro_torch.kernels import count_launch
    from repro_torch.kernels.flash_attention import ops as fa_ops

    n_threads, n_each = 8, 5000
    before = fa_ops.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [count_launch(fa_ops.__name__)
                            for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert fa_ops.launches - before == n_threads * n_each
    fa_ops.launches = before
