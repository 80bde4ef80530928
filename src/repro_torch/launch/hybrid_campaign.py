"""Mini-IMPECCABLE on the port: the hybrid AI-HPC campaign of the JAX
package's ``examples/hybrid_campaign.py``, run through the port's runtime
(``repro_torch.runtime``) with the port's model.

Every task executes on this host through the middleware:
  * docking             -> CPU function tasks (numpy scoring) on ``dragon``,
  * SST training        -> one co-scheduled (``coupling="tight"``) executable
                           task a round on ``flux``: ``make_train_step`` and
                           AdamW, the partition's mesh passed as ``mesh=``,
  * surrogate inference -> a function task through ``models.model.forward``,
  * selection           -> the docking scores pick the next batch.

The numpy draws are the example's, from ``default_rng(0)``: the candidates,
then each round's SST tokens ``candidates @ standard_normal((8, seq_len))``
and the fresh candidates. The model's weights are the port's random init
from seed 0 unless the caller passes ``params`` (a test passes the JAX
example's, through ``bridge.py``).

Run: ``python -m repro_torch.launch.hybrid_campaign [--iterations 2]
[--device cpu]``. The device is the CUDA card unless ``--device cpu`` is
given; without CUDA the default raises.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.pilot import PilotDescription
from repro_torch.core.task import TaskDescription, TaskState
from repro_torch.device import resolve_device
from repro_torch.distributed.train_step import make_train_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import PilotManager, Session, TaskManager

STAGE_TIMEOUT_S = {"docking": 300, "sst_train": 600, "inference": 300}


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wait(tmgr: TaskManager, tasks, stage: str):
    """Wait for one stage's tasks; raise unless every one is DONE."""
    if not tmgr.wait_tasks(tasks, timeout=STAGE_TIMEOUT_S[stage]):
        raise TimeoutError(f"{stage} stage exceeded "
                           f"{STAGE_TIMEOUT_S[stage]}s")
    bad = [(t.uid, t.state.value, t.error) for t in tasks
           if t.state != TaskState.DONE]
    if bad:
        raise RuntimeError(f"{stage} tasks not DONE: {bad}")


def sst_batch(batch_tokens: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """The SST train task's batch: the tokens (B, S) as tokens and labels,
    positions 0..S-1, on ``device``."""
    B, S = batch_tokens.shape
    toks = torch.as_tensor(batch_tokens, device=device)
    pos = torch.arange(S, dtype=torch.int32, device=device)[None]
    return {"tokens": toks, "labels": toks, "positions": pos.expand(B, S)}


def make_payloads(cfg: ModelConfig, state: Dict[str, Any], step,
                  dev: torch.device, train_steps: int, step_s: list,
                  meshes: list):
    """The campaign's three payloads, as the example defines them:
    ``docking(mol)`` (numpy scoring), ``train_task(batch_tokens, mesh=None)``
    (``train_steps`` steps of ``step`` on ``state["params"]`` and
    ``state["opt"]``, updated in place of the dict; returns the last loss)
    and ``inference(mol_scores)`` (a forward pass of ``state["params"]``).
    Each train task appends its steps' seconds (synchronised with the
    device) to ``step_s`` and the mesh it was given to ``meshes``."""

    def docking(mol):
        # CPU-bound scoring stand-in (AutoDock analogue)
        return float(np.sum(np.sin(mol) ** 2))

    def train_task(batch_tokens, mesh=None):
        meshes.append(mesh)             # the flux partition's, injected
        batch = sst_batch(batch_tokens, dev)
        loss, times = None, []
        for _ in range(train_steps):
            t0 = time.perf_counter()
            state["params"], state["opt"], metrics = step(
                state["params"], state["opt"], batch)
            loss = float(metrics["loss"])
            _sync(dev)
            times.append(time.perf_counter() - t0)
        step_s.append(times)
        return loss

    def inference(mol_scores):
        # surrogate inference: a forward pass scores the docking results
        toks = torch.as_tensor(
            (np.abs(mol_scores) * 1000).astype(np.int32) % cfg.vocab_size,
            device=dev).reshape(1, -1)
        pos = torch.arange(toks.shape[1], dtype=torch.int32,
                           device=dev)[None]
        with torch.no_grad():
            logits, _, _ = M.forward(state["params"], cfg,
                                     {"tokens": toks, "positions": pos},
                                     mode="train")
        return logits.float().mean(dim=(-1, -2)).cpu().numpy()

    return docking, train_task, inference


def make_step(cfg: ModelConfig):
    """The SST train step with the example's optimizer schedule."""
    return make_train_step(cfg, adamw.OptimizerConfig(total_steps=64,
                                                      warmup_steps=2))


def sst_tokens(candidates: np.ndarray, rng: np.random.Generator,
               seq_len: int, vocab_size: int) -> np.ndarray:
    """One round's SST batch, drawn from ``rng`` as the example draws it."""
    return (np.abs(candidates @ rng.standard_normal((8, seq_len)))
            * 100).astype(np.int32) % vocab_size


def select(candidates: np.ndarray, scores: np.ndarray,
           rng: np.random.Generator):
    """The adaptive selection: the best half by docking score, refilled
    with fresh draws from ``rng``. Returns (picked indices, next
    candidates)."""
    pick = np.argsort(scores)[: len(candidates) // 2]
    fresh = rng.standard_normal((len(candidates) - len(pick), 8))
    return pick, np.concatenate([candidates[pick], fresh])


def run_campaign(cfg: Optional[ModelConfig] = None, *, params=None,
                 iterations: int = 2, docking_batch: int = 16,
                 train_steps: int = 3, seq_len: int = 32, device="cuda",
                 quiet: bool = False) -> Dict[str, Any]:
    """Run the campaign; returns, per round, the SST ``losses`` (the last
    step's), the docking ``scores``, the ``selections`` (indices into that
    round's candidates), the ``inference`` outputs, the ``tokens`` of the
    SST batch, ``step_s`` (each train step's time inside the task,
    synchronised with the device) and ``meshes`` (the mesh each train task
    was given), each stage's wall seconds (``stage_s``) and ``tasks``; and
    the trained ``params``."""
    cfg = cfg if cfg is not None else get_smoke_config(
        "stablelm-3b", d_model=96, num_layers=2)
    dev = resolve_device(device)
    state = {"params": (params if params is not None
                        else M.init_params(cfg, seed=0, device=dev))}
    state["opt"] = adamw.init(state["params"])
    step_s, meshes = [], []
    docking, train_task, inference = make_payloads(
        cfg, state, make_step(cfg), dev, train_steps, step_s, meshes)

    out: Dict[str, Any] = {
        "losses": [], "scores": [], "selections": [], "inference": [],
        "tokens": [], "step_s": step_s, "meshes": meshes,
        "stage_s": {"docking": [], "sst_train": [], "inference": []},
        "tasks": {"docking": [], "sst_train": [], "inference": []}}
    session = Session(mode="real")
    try:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=1, backends={"dragon": {"workers": 4},
                               "flux": {"partitions": 1,
                                        "mesh": make_host_mesh(device=dev)}}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)
        rng = np.random.default_rng(0)
        candidates = rng.standard_normal((docking_batch, 8))
        t_start = time.perf_counter()
        for it in range(iterations):
            # stage 1: docking fan-out (dragon modality)
            t0 = time.perf_counter()
            dock = tmgr.submit_tasks([
                TaskDescription(kind="function", fn=docking, args=(m,),
                                stage="docking") for m in candidates])
            _wait(tmgr, dock, "docking")
            scores = np.asarray([t.result for t in dock])
            out["stage_s"]["docking"].append(time.perf_counter() - t0)

            # stage 2: surrogate training (flux modality, co-scheduled)
            t0 = time.perf_counter()
            toks = sst_tokens(candidates, rng, seq_len, cfg.vocab_size)
            train = tmgr.submit_tasks(TaskDescription(
                kind="executable", coupling="tight", fn=train_task,
                args=(toks,), stage="sst_train"))
            _wait(tmgr, [train], "sst_train")
            out["stage_s"]["sst_train"].append(time.perf_counter() - t0)

            # stage 3: surrogate inference + adaptive selection
            t0 = time.perf_counter()
            inf = tmgr.submit_tasks(TaskDescription(
                kind="function", fn=inference, args=(scores,),
                stage="inference"))
            _wait(tmgr, [inf], "inference")
            out["stage_s"]["inference"].append(time.perf_counter() - t0)
            pick, candidates = select(candidates, scores, rng)

            for key, val in (("losses", train.result), ("scores", scores),
                             ("selections", pick),
                             ("inference", inf.result), ("tokens", toks)):
                out[key].append(val)
            for key, val in (("docking", dock), ("sst_train", [train]),
                             ("inference", [inf])):
                out["tasks"][key].extend(val)
            if not quiet:
                print(f"[campaign] iter {it}: docked {len(dock)} (best "
                      f"{scores.min():.3f}), sst loss {train.result:.3f}, "
                      f"selected {len(pick)} for refinement", flush=True)
        all_tasks = pilot.agent.tasks
        n_done = sum(t.state == TaskState.DONE for t in all_tasks.values())
        out["wall_s"] = time.perf_counter() - t_start
        if not quiet:
            print(f"[campaign] complete: {n_done}/{len(all_tasks)} tasks in "
                  f"{out['wall_s']:.1f}s; backends: "
                  f"{sorted({t.backend for t in all_tasks.values()})}",
                  flush=True)
    finally:
        session.close()
    # the tasks keep train_task alive: drop the optimizer state it holds
    out["params"] = state.pop("params")
    state.clear()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--docking-batch", type=int, default=16)
    ap.add_argument("--train-steps", type=int, default=3)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--full", action="store_true",
                    help="the published config, not the example's reduced "
                         "one (d_model 96, 2 layers)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = (get_config(args.arch) if args.full else get_smoke_config(
        args.arch, d_model=96, num_layers=2))
    run_campaign(cfg, iterations=args.iterations,
                 docking_batch=args.docking_batch,
                 train_steps=args.train_steps, seq_len=args.seq_len,
                 device=args.device)


if __name__ == "__main__":
    main()
