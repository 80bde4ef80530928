"""Quickstart on the port: the three layers of the framework, as the JAX
package's ``examples/quickstart.py`` shows them.

1. simulate a paper-scale runtime experiment (srun vs flux) and read the
   paper's metrics from its trace (``compute_metrics``),
2. train a small LM for a few steps through ``launch/train.py``,
3. push a hybrid task mix through the real middleware.

Both 1. and 3. go through the same RP-style Session API — only the session
``mode`` ("sim" vs "real") swaps the execution substrate.

Run: ``python -m repro_torch.launch.quickstart [--device cpu]``. Sections 2
and 3 run on the CUDA card unless ``--device cpu`` is given; without CUDA
the default raises.
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import (PilotDescription, PilotManager, Session,
                              TaskDescription, TaskManager, compute_metrics)
from repro_torch.core.analytics import RunMetrics
from repro_torch.device import resolve_device


def sim_experiment() -> Dict[str, RunMetrics]:
    """896 three-minute single-core tasks on 4 simulated Frontier nodes,
    under srun and under flux; returns each backend's metrics."""
    print("== 1. simulated runtime experiment (4 Frontier nodes) ==")
    out = {}
    for backend in ({"srun": {}}, {"flux": {"partitions": 2}}):
        with Session(mode="sim", seed=0) as session:
            pilot = PilotManager(session).submit_pilots(
                PilotDescription(nodes=4, backends=backend))
            tmgr = TaskManager(session)
            tmgr.add_pilots(pilot)
            tmgr.submit_tasks([TaskDescription(cores=1, duration=180.0)
                               for _ in range(896)])
            tmgr.wait_tasks()
            agent = pilot.agent
            m = compute_metrics(list(agent.tasks.values()), agent.total_cores)
        name = list(backend)[0]
        out[name] = m
        print(f"  {name:5s}: makespan={m.makespan:7.0f}s "
              f"util={m.utilization:.2f} peak_conc={m.concurrency_peak}")
    return out


def tiny_training(device) -> Dict:
    """Five steps of the reduced gemma-7b family config through
    ``train()``; returns its output."""
    print("== 2. real training (reduced gemma-7b family config) ==")
    from repro_torch.launch.train import train
    cfg = get_smoke_config("gemma-7b")
    out = train(cfg, steps=5, global_batch=2, seq_len=32, quiet=True,
                device=device)
    print(f"  5 steps, loss {out['losses'][0]:.3f} -> {out['final_loss']:.3f}")
    return out


def hybrid_middleware(device) -> list:
    """Function tasks on dragon that compute on ``device``, a co-scheduled
    callable on flux and an executable through popen; returns the tasks."""
    print("== 3. hybrid task mix through the real middleware ==")
    dev = resolve_device(device)

    def arange_sum(i):
        return float(torch.arange(i + 1, device=dev).sum())

    with Session(mode="real") as session:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=1, backends={"dragon": {"workers": 2},
                               "flux": {"partitions": 1},
                               "popen": {}}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)
        tasks = tmgr.submit_tasks(
            [TaskDescription(kind="function", fn=arange_sum, args=(i,))
             for i in range(4)]
            + [TaskDescription(kind="executable",
                               fn=lambda: "co-scheduled step done")]
            + [TaskDescription(kind="executable", executable="uname",
                               arguments=("-s",))])
        tmgr.wait_tasks(timeout=60)
        print(f"  {sum(t.state.value == 'DONE' for t in tasks)}/6 tasks done; "
              f"backends used: {sorted({t.backend for t in tasks})}")
    return tasks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    sim_experiment()
    tiny_training(args.device)
    hybrid_middleware(args.device)


if __name__ == "__main__":
    main()
