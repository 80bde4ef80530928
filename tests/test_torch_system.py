"""The hybrid AI-HPC workload with the port: a twin of
tests/test_system.py::test_real_hybrid_ai_hpc_workload in which the AI half
is ``repro_torch``. The port's train step on the stablelm-3b smoke config
runs as co-scheduled (``coupling="tight"``) executable tasks on the real
``flux`` backend and its forward as function tasks on ``dragon``, through
the JAX package's runtime (``repro.core.LocalRuntime``) on the CPU. The
runtime imports the callables it is given and nothing of them; the port
imports nothing of the runtime.

Its twin runs the same tasks through the port's own runtime
(``repro_torch.core.local.LocalRuntime``), with the port's one-process mesh
passed to ``flux``, and must give the same losses and outputs."""
import numpy as np
import torch

from repro.core import local as jlocal
from repro.core import task as jtask
from repro_torch.core import local as tlocal
from repro_torch.core import task as ttask
from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.train_step import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import adamw


def _workload(local, task_mod, mesh=None):
    """The port's train and forward tasks through ``local.LocalRuntime``;
    returns the losses and the inference outputs."""
    TaskDescription, TaskState = task_mod.TaskDescription, task_mod.TaskState
    cfg = get_smoke_config("stablelm-3b")
    params = M.init_params(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, adamw.OptimizerConfig())
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "labels": tokens,
             "positions": torch.arange(16).expand(2, 16)}

    def train_task(mesh=None):
        # the update is in place: each task trains its own copy
        own = T.tree_map(torch.clone, params)
        _, _, metrics = step(own, adamw.init(own), batch)
        return float(metrics["loss"])

    def infer_task(seed):
        g = torch.Generator().manual_seed(seed)
        toks = torch.randint(0, cfg.vocab_size, (1, 8), generator=g)
        with torch.no_grad():
            logits, _, _ = M.forward(
                params, cfg, {"tokens": toks,
                              "positions": torch.arange(8).expand(1, 8)})
        return float(logits.float().abs().sum())

    rt = local.LocalRuntime(n_function_workers=2, n_partitions=1,
                            mesh=mesh)
    descs = [TaskDescription(kind="executable", fn=train_task,
                             coupling="tight") for _ in range(2)]
    descs += [TaskDescription(kind="function", fn=infer_task, args=(i,))
              for i in range(4)]
    tasks = rt.submit(descs)
    try:
        assert rt.wait(timeout=120)
        assert all(t.state == TaskState.DONE for t in tasks)
        losses = [t.result for t in tasks
                  if t.description.kind == "executable"]
        assert len(losses) == 2
        assert all(np.isfinite(l) and l > 0 for l in losses)
        assert losses[0] == losses[1]          # same weights, same batch
        outs = [t.result for t in tasks if t.description.kind == "function"]
        assert all(np.isfinite(o) and o > 0 for o in outs)
        assert {t.backend for t in tasks} == {"flux", "dragon"}
    finally:
        rt.shutdown()
    return losses, outs


def test_real_hybrid_ai_hpc_workload_with_the_port():
    _workload(jlocal, jtask)


def test_real_hybrid_ai_hpc_workload_through_the_ports_runtime():
    from repro_torch.launch.mesh import make_host_mesh
    got = _workload(tlocal, ttask, mesh=make_host_mesh(device="cpu"))
    want = _workload(jlocal, jtask)
    assert got == want
