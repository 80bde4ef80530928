"""The life of a rank group (``repro_torch.launch.ranks``) under the flux
executor, on CPU devices over gloo: two partitions' groups at once, a rank
that raises, the walltime, ``fail_task`` and a deadline killing a group, a
checkpointed ``train()`` task resuming on a group, callables that cannot
cross to the ranks, and the backend rule of ``launch/mesh.mesh_backend``.

Every case checks that no rank outlives its task and that the partition
then runs its next task. The rank bodies live in ``tests/torch_ranks.py``
(no JAX in a spawned rank); this module imports no JAX either.
"""
import os
import threading
import time

import pytest
import torch

import torch_ranks as R
from repro_torch.core import local as tlocal
from repro_torch.core import task as ttask
from repro_torch.core.partition import carve_submeshes
from repro_torch.launch.mesh import make_local_mesh, mesh_backend
from repro_torch.launch.ranks import RankError, RankGroup, run_on_mesh

CPUS = [torch.device("cpu", i) for i in range(4)]
OPT = dict(total_steps=10, warmup_steps=1)
WAIT_S = 180.0
KILLED_WITHIN_S = 15.0


def _runtime(mp=2, devices=CPUS[:2], n=1):
    return tlocal.LocalRuntime(mesh=make_local_mesh(mp, devices=devices),
                               n_partitions=n)


def _desc(fn, *args, **kw):
    return ttask.TaskDescription(kind="executable", coupling="tight", fn=fn,
                                 args=args, **kw)


def _run(rt, *descs):
    tasks = rt.submit(list(descs))
    assert rt.wait(timeout=WAIT_S)
    return tasks


def _alive(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _group(rt, task):
    return rt.agent.backends["flux"].rank_groups[task.uid]


def _no_rank_left(rt, *tasks):
    for t in tasks:
        pids = _group(rt, t)["pids"]
        assert pids and not any(map(_alive, pids)), (t.uid, pids)


def test_two_partitions_run_their_rank_groups_at_once(tmp_path):
    """A (2, 2) mesh of CPU devices carved into two (1, 2) partitions: both
    tasks' groups enter one barrier of four ranks, so they ran at once,
    each on its own partition's devices."""
    rt = _runtime(devices=CPUS, n=2)
    try:
        tasks = _run(rt, *(_desc(R.flux_barrier, str(tmp_path), 4)
                           for _ in range(2)))
        assert [t.state.value for t in tasks] == ["DONE"] * 2, [
            t.error for t in tasks]
        groups = [_group(rt, t) for t in tasks]
        parts = [rt.partitions[t.partition].mesh for t in tasks]
        _no_rank_left(rt, *tasks)
    finally:
        rt.shutdown()
    assert sorted(t.partition for t in tasks) == [0, 1]
    for t, g, part in zip(tasks, groups, parts):
        assert t.result == {"data": 1, "model": 2}
        assert g["devices"] == [str(d) for d in part.devices.flat]
        assert [r["device"] for r in g["ranks"]] == g["devices"]
        assert g["backend"] == "gloo" and g["spawn_s"] > 0
    ranks = [r for g in groups for r in g["ranks"]]
    assert max(r["t0"] for r in ranks) < min(r["t1"] for r in ranks)


@pytest.mark.parametrize("bad_rank", [0, 1])
def test_a_rank_that_raises_fails_the_task(bad_rank):
    """The rank's traceback in ``task.error``; the other rank, waiting in
    a collective, killed; no rank left; the partition's next task DONE."""
    rt = _runtime()
    try:
        bad, = _run(rt, _desc(R.flux_raise, bad_rank))
        assert bad.state.value == "FAILED"
        assert f"rank {bad_rank} of 2 on cpu:{bad_rank}" in bad.error
        assert "Traceback" in bad.error and "fails on purpose" in bad.error
        _no_rank_left(rt, bad)
        nxt, = _run(rt, _desc(R.flux_sleep, 0))
        assert nxt.state.value == "DONE" and nxt.result == 0, nxt.error
        assert nxt.partition == bad.partition
    finally:
        rt.shutdown()


def _killed_while_running(rt, task, kill):
    """Wait until ``task``'s group runs, ``kill()`` it, and return the
    seconds until every rank of it has exited."""
    ex = rt.agent.backends["flux"]
    deadline = time.monotonic() + WAIT_S
    while True:
        with ex.engine.lock:
            group = ex._groups.get(task.uid)
        if group is not None and group.ranks == [] and len(group.pids) == 2:
            break
        assert time.monotonic() < deadline, "the group never started"
        time.sleep(0.05)
    time.sleep(1.0)
    t0 = time.monotonic()
    kill()
    while any(map(_alive, group.pids)):
        assert time.monotonic() - t0 < KILLED_WITHIN_S, group.pids
        time.sleep(0.05)
    return time.monotonic() - t0


@pytest.mark.parametrize("how", ["walltime", "fail_task"])
def test_a_killed_task_kills_its_rank_group(how):
    """A task of two ranks sleeping 120 s: its walltime (3 s), or the
    executor's ``fail_task``, fails it and kills both ranks within
    KILLED_WITHIN_S; the partition's next task is DONE."""
    rt = _runtime()
    ex = rt.agent.backends["flux"]
    try:
        if how == "walltime":
            task, = rt.submit([_desc(R.flux_sleep, 120, walltime=3.0)])
            t0 = time.monotonic()
            assert rt.wait(timeout=WAIT_S)
            assert time.monotonic() - t0 < WAIT_S / 2
        else:
            task, = rt.submit([_desc(R.flux_sleep, 120)])
            _killed_while_running(
                rt, task, lambda: ex.fail_task(task, "killed by the test"))
            assert rt.wait(timeout=WAIT_S)
        assert task.state.value == "FAILED"
        assert ("walltime exceeded" if how == "walltime"
                else "killed by the test") in task.error
        nxt, = _run(rt, _desc(R.flux_sleep, 0))
        assert nxt.state.value == "DONE", nxt.error
        _no_rank_left(rt, task, nxt)
    finally:
        rt.shutdown()


def test_a_checkpointed_train_task_resumes_on_a_rank_group(tmp_path):
    """``train()`` of stablelm-3b's smoke config as flux tasks on a (1, 2)
    partition: 3 steps into ``checkpoint_dir``, then a second task to 6
    that the executor resumes from step 3 (the checkpoint manager and
    ``resume_from`` on every rank): the losses equal in every bit to one
    uninterrupted task of 6 steps."""
    rt = _runtime()
    try:
        whole, = _run(rt, _desc(R.flux_train, "stablelm-3b", 6, OPT))
        ckpt = str(tmp_path / "ckpt")
        first, = _run(rt, _desc(R.flux_train, "stablelm-3b", 3, OPT,
                                checkpoint_dir=ckpt))
        second, = _run(rt, _desc(R.flux_train, "stablelm-3b", 6, OPT,
                                 checkpoint_dir=ckpt))
        _no_rank_left(rt, whole, first, second)
    finally:
        rt.shutdown()
    for t in (whole, first, second):
        assert t.state.value == "DONE", t.error
    want = whole.result["losses"]
    assert len(want) == 6
    assert first.result == {"losses": want[:3], "resume_from": None}
    assert second.result == {"losses": want[3:], "resume_from": 3}
    assert sorted(os.listdir(ckpt)) == ["step_00000003", "step_00000006"]


@pytest.mark.parametrize("case", ["lambda", "closure", "argument",
                                  "no mesh"])
def test_a_task_that_cannot_run_on_ranks_fails_with_its_reason(case):
    """A callable or argument that does not pickle, or a callable that
    takes no ``mesh=``, fails the task with the reason; it never runs in
    the executor's thread instead."""
    ran = []

    def closure(mesh=None):
        ran.append(mesh)

    fn, args = {"lambda": (lambda mesh=None: ran.append(mesh), ()),
                "closure": (closure, ()),
                "argument": (R.flux_sleep, (threading.Lock(),)),
                "no mesh": (R.play_launches, ())}[case]
    rt = _runtime()
    try:
        task, = _run(rt, _desc(fn, *args))
        nxt, = _run(rt, _desc(R.flux_sleep, 0))
    finally:
        rt.shutdown()
    assert task.state.value == "FAILED" and not ran
    assert ("takes no mesh=" if case == "no mesh"
            else "is not picklable") in task.error, task.error
    assert nxt.state.value == "DONE", nxt.error


def test_run_on_mesh_returns_rank_0s_value_and_keeps_its_deadline(tmp_path):
    """Directly, on partition 1 of a (4, 1) mesh ((2, 1): cpu:2, cpu:3):
    rank 0's value; a deadline of 8 s kills a group sleeping 120 s."""
    part = carve_submeshes(make_local_mesh(devices=CPUS), 2)[1].mesh
    group = RankGroup(part, R.flux_sleep, (0.5,))
    assert group.run(timeout=WAIT_S) == 0.5
    assert [r["device"] for r in group.ranks] == ["cpu:2", "cpu:3"]
    assert run_on_mesh(part, R.flux_barrier, str(tmp_path), 2) == {
        "data": 2, "model": 1}
    group = RankGroup(part, R.flux_sleep, (120,))
    t0 = time.monotonic()
    with pytest.raises(RankError, match="deadline of 8.0 s"):
        group.run(timeout=8.0)
    assert time.monotonic() - t0 < 8.0 + KILLED_WITHIN_S
    assert not any(map(_alive, group.pids))


def test_backend_rule_of_a_local_mesh():
    """NCCL over distinct cards; gloo over CPU devices or a repeated card
    (which ``make_local_mesh`` accepts); a mesh of both refused."""
    cards = [torch.device("cuda", i) for i in range(4)]
    assert mesh_backend(make_local_mesh(2, devices=CPUS)) == "gloo"
    assert mesh_backend(make_local_mesh(2, devices=cards)) == "nccl"
    repeated = make_local_mesh(2, devices=[cards[0]] * 4)
    assert mesh_backend(repeated) == "gloo"
    assert [mesh_backend(p.mesh) for p in carve_submeshes(repeated, 2)] == [
        "gloo", "gloo"]
    assert [mesh_backend(p.mesh) for p in carve_submeshes(
        make_local_mesh(2, devices=cards), 2)] == ["nccl", "nccl"]
    with pytest.raises(ValueError, match="CPU devices or cards"):
        mesh_backend(make_local_mesh(devices=[CPUS[0], cards[0]]))
