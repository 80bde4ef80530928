"""Flux partitions over the devices of one process (ROADMAP item 8c): the
port's ``carve_submeshes`` of a local mesh (``launch/mesh.make_local_mesh``)
against JAX's carve of ``make_host_mesh()`` over four forced host devices
(a JAX subprocess, ``torch_ranks.run_jax``), four co-scheduled tasks through
``LocalRuntime`` in both packages, the port's train step as a flux task on a
one-device partition against JAX's unsharded step, and a flux task on a
partition of several local devices (ROADMAP item 8d): the executor spawns a
rank group over the partition (``launch/ranks.py``), whose train step and
``generate`` are held against JAX's unsharded step and one-rank
``generate``; a direct call over such a partition names that route. The
rank bodies live in ``tests/torch_ranks.py``, which imports no JAX.

The port's local meshes here hold CPU devices named by index (``cpu:i``), so
each partition's devices can be told apart and matched by position to the
parent's list; a CPU tensor carries no index, and a step on such a mesh runs
on the CPU as on one rank.
"""
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.distributed.train_step import make_train_step as jmake_train_step
from repro.models import model as jM
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.core import local as tlocal
from repro_torch.core import task as ttask
from repro_torch.core.partition import carve_submeshes
from repro_torch.distributed.train_step import (kernel_launches,
                                                make_train_step)
from repro_torch.launch.mesh import make_host_mesh, make_local_mesh
from repro_torch.launch.serve import generate
from repro_torch.models import model as M
from repro_torch.optim import adamw
import torch_ranks
from torch_ranks import run_jax

CPUS = [torch.device("cpu", i) for i in range(4)]
CARVES = [(1, 1), (1, 2), (1, 3), (1, 4), (1, 8), (2, 2)]  # (model, parts)
BARRIER_S = 20.0
TOL = 1e-4                  # tests/test_torch_train.py's
OPT = dict(total_steps=10, warmup_steps=1)

_JAX_CARVES = f"""
import json
from repro.core.partition import carve_submeshes
from repro.launch.mesh import make_host_mesh
out = []
for mp, n in {CARVES!r}:
    mesh = make_host_mesh(mp)
    order = [d.id for d in mesh.devices.flat]
    out.append([(p.index, dict(p.mesh.shape),
                 [[order.index(d.id) for d in row]
                  for row in p.mesh.devices.tolist()])
                for p in carve_submeshes(mesh, n)])
print(json.dumps(out))
"""


def _positions(mesh, parent):
    """Each device of ``mesh`` by its position in ``parent``'s list."""
    order = list(parent.devices.flat)
    return [[order.index(d) for d in row] for row in mesh.devices.tolist()]


def test_carve_of_local_devices_matches_jax():
    """Same partition count, indices, shapes and devices, by position in
    the parent's device list, as JAX's carve of four host devices: 1, 2, 3,
    4 and 8 partitions of (4, 1) (the last takes the remainder; 8 gives 4),
    and a (2, 2) mesh carved into 2 along ``data``, ``model`` whole."""
    want = json.loads(run_jax(_JAX_CARVES, 4).strip().splitlines()[-1])
    for (mp, n), jparts in zip(CARVES, want):
        mesh = make_local_mesh(mp, devices=CPUS)
        parts = carve_submeshes(mesh, n)
        got = [[p.index, p.mesh.shape, _positions(p.mesh, mesh)]
               for p in parts]
        assert got == [list(p) for p in jparts], (mp, n)
        # [cpu] * 4, as a CPU host lists its one device: the same carve
        same = carve_submeshes(make_local_mesh(mp, devices=["cpu"] * 4), n)
        assert [(p.index, p.mesh.shape) for p in same] == [
            (p[0], p[1]) for p in jparts]
        assert all(d == torch.device("cpu") for p in same
                   for d in p.mesh.devices.flat)


def test_local_mesh_devices_and_placement():
    mesh = make_local_mesh(devices=CPUS)
    assert mesh.shape == {"data": 4, "model": 1}
    assert list(mesh.devices.flat) == CPUS and "local" in repr(mesh)
    with pytest.raises(ValueError):
        mesh.device                      # four devices
    one = carve_submeshes(mesh, 4)[2].mesh
    assert one.device == CPUS[2]
    with one.placement():                # nothing to make current on the CPU
        assert torch.zeros(1).device.type == "cpu"
    # the one-process mesh over ranks keeps its meaning and its one partition
    host = make_host_mesh(device="cpu")
    assert host.devices is None and carve_submeshes(host, 4)[0].mesh is host
    with pytest.raises(ValueError):
        host.device
    with pytest.raises(ValueError):
        make_local_mesh(3, devices=CPUS)
    with pytest.raises(ValueError):
        make_local_mesh(devices=["cuda"])    # a card without its index


_JAX_RUNTIME = f"""
import json, threading
from repro.core.local import LocalRuntime
from repro.core.task import TaskDescription, TaskState
from repro.launch.mesh import make_host_mesh
barrier = threading.Barrier(4, timeout={BARRIER_S})
def task(mesh=None):
    barrier.wait()
    return [d.id for d in mesh.devices.flat]
rt = LocalRuntime(mesh=make_host_mesh(), n_partitions=4)
try:
    tasks = rt.submit([TaskDescription(kind="executable", coupling="tight",
                                       fn=task) for _ in range(4)])
    assert rt.wait(timeout=60)
    print(json.dumps([(t.state.value, t.backend, t.partition, t.result)
                      for t in tasks]))
finally:
    rt.shutdown()
"""


def _port_runtime():
    barrier = threading.Barrier(4, timeout=BARRIER_S)

    def task(mesh=None):
        barrier.wait()              # all four hold their partitions at once
        return [d.index for d in mesh.devices.flat]

    rt = tlocal.LocalRuntime(mesh=make_local_mesh(devices=CPUS),
                             n_partitions=4)
    try:
        assert len(rt.partitions) == 4
        tasks = rt.submit([ttask.TaskDescription(
            kind="executable", coupling="tight", fn=task) for _ in range(4)])
        assert rt.wait(timeout=60)
        return [(t.state.value, t.backend, t.partition, t.result)
                for t in tasks]
    finally:
        rt.shutdown()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_four_partitions_run_four_tasks_at_once(package):
    """Four flux tasks, each waiting on one barrier of four: they finish
    only if they ran concurrently. Each gets its partition's one-device
    mesh, and ``task.partition`` is that partition's index."""
    if package == "jax":
        out = json.loads(run_jax(_JAX_RUNTIME, 4).strip().splitlines()[-1])
    else:
        out = _port_runtime()
    assert sorted(p for _, _, p, _ in out) == [0, 1, 2, 3]
    for state, backend, part, devices in out:
        assert (state, backend) == ("DONE", "flux")
        assert devices == [part]


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    nb = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
          "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                       (B, S)).copy()}
    return nb, {k: torch.from_numpy(v) for k, v in nb.items()}


def _rel(a, b):
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)


def _jax_step():
    """JAX's unsharded train step of stablelm-3b's f32 smoke config: the
    numpy weights, batch, loss and updated leaves by path."""
    jcfg = jget_smoke("stablelm-3b", dtype="float32")
    jparams = jM.init_params(jax.random.PRNGKey(0), jcfg)
    nb, tb = _batch(jcfg)
    jnew, _, jm = jax.jit(jmake_train_step(jcfg, jadamw.OptimizerConfig(
        **OPT)))(jparams, jadamw.init(jparams), nb)
    jnew = {"/".join(str(k.key) for k in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jnew)[0]}
    return jax.tree.map(np.asarray, jparams), nb, tb, float(jm["loss"]), jnew


def test_train_step_as_a_flux_task_on_a_one_device_partition_matches_jax():
    """stablelm-3b's f32 smoke config: the port's train step, made on the
    partition's mesh inside a flux task of a four-partition runtime, against
    JAX's unsharded step on the same numpy weights (the loss and every
    updated leaf within tests/test_torch_train.py's 1e-4)."""
    nparams, _, tb, jloss, jnew = _jax_step()
    cfg = get_smoke_config("stablelm-3b", dtype="float32")

    def train(mesh=None):
        params = bridge.to_torch(nparams, device=mesh.device)
        step = make_train_step(cfg, adamw.OptimizerConfig(**OPT), mesh=mesh)
        assert step.layout is None                  # one rank: no collective
        new, _, m = step(params, adamw.init(params), tb)
        return mesh.device, float(m["loss"]), new

    rt = tlocal.LocalRuntime(mesh=make_local_mesh(devices=CPUS),
                             n_partitions=4)
    try:
        task, = rt.submit([ttask.TaskDescription(
            kind="executable", coupling="tight", fn=train)])
        assert rt.wait(timeout=120)
        assert task.state.value == "DONE", task.error
    finally:
        rt.shutdown()
    dev, loss, new = task.result
    assert dev == CPUS[task.partition]
    np.testing.assert_allclose(loss, jloss, rtol=TOL, atol=TOL)
    for path, t in T.flatten(new):
        assert _rel(t, torch.from_numpy(jnew[path])) < TOL, path


# (model parallel of the local mesh, its shape): two partitions of two CPU
# devices each, (2, 1) along ``data`` or (1, 2) along ``model``
SEVERAL = {(2, 1): 1, (1, 2): 2}


def _on_a_rank_group(shape, fn, *args):
    """``fn(*args)`` as the one flux task of a runtime whose local mesh of
    four CPU devices is carved into two partitions of ``shape``: the task
    and its rank group's summary."""
    rt = tlocal.LocalRuntime(mesh=make_local_mesh(SEVERAL[shape],
                                                  devices=CPUS),
                             n_partitions=2)
    try:
        task, = rt.submit([ttask.TaskDescription(
            kind="executable", coupling="tight", fn=fn, args=args)])
        assert rt.wait(timeout=180)
        assert task.state.value == "DONE", task.error
        part = rt.partitions[task.partition].mesh
        group = rt.agent.backends["flux"].rank_groups[task.uid]
    finally:
        rt.shutdown()
    assert part.shape == dict(zip(("data", "model"), shape))
    assert group["devices"] == [str(d) for d in part.devices.flat]
    assert group["backend"] == "gloo" and len(group["ranks"]) == 2
    assert [r["device"] for r in group["ranks"]] == group["devices"]
    return task, group


@pytest.mark.parametrize("shape", list(SEVERAL), ids=str)
def test_train_step_as_a_flux_task_over_a_rank_group_matches_jax(shape):
    """A flux task on a partition of two CPU devices runs on a gloo rank
    group the executor spawns over them, each rank's step made over the
    group's mesh of the partition's shape (ZeRO-1 over ``data`` on (2, 1),
    tensor parallel over ``model`` on (1, 2)): rank 0's loss and every
    gathered updated leaf within 1e-4 of JAX's unsharded step on the same
    numpy weights (the leaves elementwise, as
    tests/test_torch_tensor_parallel.py holds a tensor-parallel step: Adam's
    first update turns gradient rounding near eps into update gaps), its
    tensors back on the partition's first device."""
    nparams, nb, _, jloss, jnew = _jax_step()
    task, group = _on_a_rank_group(shape, torch_ranks.flux_train_step,
                                   "stablelm-3b", nparams, nb, OPT)
    r = task.result
    assert r["shape"] == dict(zip(("data", "model"), shape))
    assert r["world"] == 2 and r["coord"] == {"data": 0, "model": 0}
    assert r["loss"].device.type == "cpu"
    np.testing.assert_allclose(float(r["loss"]), jloss, rtol=TOL, atol=TOL)
    assert sorted(r["params"]) == sorted(jnew)
    for path, t in r["params"].items():     # test_torch_tensor_parallel's
        np.testing.assert_allclose(t.numpy(), jnew[path], rtol=TOL, atol=TOL,
                                   err_msg=path)
    # each rank played one step's launches (the plain versions in place),
    # counted in the rank body and in the rank's report alike
    want = kernel_launches(get_smoke_config("stablelm-3b", dtype="float32"),
                           shape[1])
    assert r["launches"] == {k: n for k, n in want.items()
                             if k != "decode_attention"}
    for rank in group["ranks"]:
        assert rank["launches"] == want, rank


@pytest.mark.parametrize("shape", list(SEVERAL), ids=str)
def test_generate_as_a_flux_task_over_a_rank_group(shape):
    """``generate`` of stablelm-3b's f32 smoke config as a flux task on a
    partition of two CPU devices, over the group's mesh: the tokens of
    one-rank ``generate`` on the same weights."""
    cfg = get_smoke_config("stablelm-3b", dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8), dtype=np.int32)
    want = generate(params, cfg, torch.from_numpy(prompts), max_new_tokens=4)
    task, _ = _on_a_rank_group(shape, torch_ranks.flux_generate,
                               "stablelm-3b", bridge.to_numpy(params),
                               prompts, 4)
    assert torch.equal(task.result, want)


@pytest.mark.parametrize("mp,n", [(1, 2), (2, 2)])
def test_a_direct_step_over_several_local_devices_names_the_route(mp, n):
    """A partition of two local devices ((2, 1) along ``data``, or (1, 2)
    along ``model``) called directly in this process: the train step and
    ``generate`` refuse it, naming ``run_on_mesh`` and the flux executor;
    a one-device partition's ``generate`` serves as on one rank and
    refuses prompts on another device type."""
    cfg = get_smoke_config("stablelm-3b", dtype="float32")
    part = carve_submeshes(make_local_mesh(mp, devices=CPUS), n)[0].mesh
    assert part.size == 2
    with pytest.raises(NotImplementedError, match="run_on_mesh.*flux"):
        make_train_step(cfg, adamw.OptimizerConfig(**OPT), mesh=part)
    params = M.init_params(cfg, seed=0, device="cpu")
    prompts = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="run_on_mesh.*flux"):
        generate(params, cfg, prompts, max_new_tokens=2, mesh=part)
    # one device: generate serves as on one rank
    one = carve_submeshes(make_local_mesh(devices=CPUS), 4)[1].mesh
    want = generate(params, cfg, prompts, max_new_tokens=2)
    assert torch.equal(generate(params, cfg, prompts, max_new_tokens=2,
                                mesh=one), want)
    meta = carve_submeshes(make_local_mesh(devices=["meta"]), 1)[0].mesh
    with pytest.raises(ValueError, match="the prompts"):
        generate(params, cfg, prompts, max_new_tokens=2, mesh=meta)
