"""The hybrid campaign's round, in a closed loop of rounds, through the
port's runtime: the traffic of ``launch/hybrid_campaign.py`` (the JAX
package's ``examples/hybrid_campaign.py``), copied here.

A round: ``docking_tasks`` docking function tasks on Dragon (numpy
scoring of each candidate); then one tight-coupled Flux executable task
of ``train_steps`` AdamW steps on the round's SST batch (one sequence of
``seq_len`` tokens a candidate); then one surrogate-inference function
task (a forward pass of the model); then the selection of the next
candidates. The candidates and each round's draws come from the seed.

The first round is set-up. Its train task's first steps are the ones the
reference follows: after step 1 the payload reads the gradient as the
optimizer got it from the first moment (m1 / (1 - beta1)), after step
``reference_steps`` the parameters' change, each by leaf (a stacked leaf
by its layers) as a norm and at a sample of coordinates drawn from the
seed. The window runs whole rounds, begun while its time lasts.
"""
from __future__ import annotations

import time
import zlib
from typing import Dict, List

import numpy as np
import torch

from bench import weights

FAULTS = ("unchanged", "half_batch", "answer")
SAMPLE = 4096


def docking(mol: np.ndarray) -> float:
    """The example's CPU-bound scoring stand-in (an AutoDock analogue)."""
    return float(np.sum(np.sin(mol) ** 2))


def altered(mol: np.ndarray) -> float:
    """``docking`` with its answer altered where it is produced: the
    fault that ``wrong_answers`` catches."""
    return docking(mol) + 1e-3


def sst_tokens(candidates: np.ndarray, rng: np.random.Generator,
               seq_len: int, vocab: int) -> np.ndarray:
    """One round's SST batch, drawn as the example draws it."""
    return (np.abs(candidates @ rng.standard_normal((candidates.shape[1],
                                                     seq_len)))
            * 100).astype(np.int32) % vocab


def select(candidates: np.ndarray, scores: np.ndarray,
           rng: np.random.Generator):
    """The best half by docking score, refilled with fresh draws."""
    pick = np.argsort(scores)[: len(candidates) // 2]
    fresh = rng.standard_normal((len(candidates) - len(pick),
                                 candidates.shape[1]))
    return np.concatenate([candidates[pick], fresh])


def slices(tree_items):
    """(name, tensor) of each leaf, a ``layers/`` leaf by its layers."""
    for path, t in tree_items:
        if path.startswith("layers/"):
            for i in range(t.shape[0]):
                yield f"{path}:{i}", t[i]
        else:
            yield path, t


def sample_index(seed: int, name: str, numel: int, device) -> torch.Tensor:
    rng = np.random.default_rng([abs(seed), zlib.crc32(name.encode())])
    idx = rng.integers(0, numel, size=min(SAMPLE, numel))
    return torch.as_tensor(idx, device=device)


def leaf_readings(seed: int, named, scale: float = 1.0) -> Dict:
    """{name: (norm, sampled coordinates)} of (name, tensor) pairs."""
    out = {}
    for name, t in named:
        flat = t.reshape(-1).float() * scale
        idx = sample_index(seed, name, flat.numel(), flat.device)
        out[name] = (float(torch.linalg.vector_norm(flat)),
                     flat[idx].cpu().numpy().astype(np.float64))
    return out


def gaps(prog: Dict, ref: Dict, counted) -> Dict[str, float]:
    """The worst leaf's gap of norms, and of sampled coordinates, each
    against the reference leaf's or the median leaf's, the larger."""
    med_n = float(np.median([ref[n][0] for n in counted]))
    med_s = float(np.median([np.linalg.norm(ref[n][1]) for n in counted]))
    norm = max(abs(prog[n][0] - ref[n][0]) / max(ref[n][0], med_n, 1e-30)
               for n in counted)
    coords = max(np.linalg.norm(prog[n][1] - ref[n][1])
                 / max(np.linalg.norm(ref[n][1]), med_s, 1e-30)
                 for n in counted)
    return {"norm": float(norm), "coords": float(coords)}


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        self.B, self.S = tr["docking_tasks"], tr["seq_len"]
        self.n_steps, self.n_ref = tr["train_steps"], tr["reference_steps"]
        self.opt = tr["optimizer"]
        self.tasks: List[Dict] = []
        self.steps: List[float] = []
        self.work: Dict = {"flash_fwd": [], "train_steps": []}
        self.attempted = self.failed = 0
        self.docked = []                 # (candidate, result) of every task
        self.prog = {}                   # the program's readings

    # ------------------------------------------------------------ set-up
    def setup(self):
        from repro_torch.core.pilot import PilotDescription
        from repro_torch.distributed.train_step import (make_eval_step,
                                                        make_train_step)
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.optim import adamw
        from repro_torch.runtime import PilotManager, Session, TaskManager
        ctx, dev = self.ctx, self.ctx.device
        params = weights.to_program(ctx.cfg, weights.make(ctx.ref, ctx.m,
                                                          ctx.seed, dev))
        self.state = {"params": params, "opt": adamw.init(params)}
        step = make_train_step(ctx.cfg, adamw.OptimizerConfig(
            **dict(self.opt, betas=tuple(self.opt["betas"]))))
        if ctx.fault == "unchanged":
            evaluate = make_eval_step(ctx.cfg)
            step = lambda p, s, b: (p, s, evaluate(p, b))      # noqa: E731
        self.step = step
        self.session = Session(mode="real")
        pilot = PilotManager(self.session).submit_pilots(PilotDescription(
            nodes=1, backends={
                "dragon": {"workers": ctx.traffic["dragon_workers"]},
                "flux": {"partitions": 1,
                         "mesh": make_host_mesh(device=dev)}}))
        self.tmgr = TaskManager(self.session)
        self.tmgr.add_pilots(pilot)
        self.rng = np.random.default_rng(abs(ctx.seed))
        self.candidates = self.rng.standard_normal((self.B,
                                                    ctx.traffic["dock_dim"]))
        self.first_batch = None
        self.round(setup=True)

    # ---------------------------------------------------------- payloads
    def _train_task(self, batch_tokens, setup, mesh=None):
        """The Flux payload: ``train_steps`` steps on the round's batch;
        returns (the last loss, the body's seconds). ``mesh`` is the
        partition's (one card: the step runs on it as made)."""
        t_body = time.perf_counter()
        dev, st = self.ctx.device, self.state
        if self.ctx.fault == "half_batch":
            batch_tokens = batch_tokens[: len(batch_tokens) // 2]
        toks = torch.as_tensor(batch_tokens, device=dev)
        B, S = toks.shape
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
        batch = {"tokens": toks, "labels": toks, "positions": pos}
        loss = None
        for k in range(1, self.n_steps + 1):
            t0 = time.perf_counter()
            with self.ctx.spans.span("train.step"):
                st["params"], st["opt"], metrics = self.step(
                    st["params"], st["opt"], batch)
                loss = float(metrics["loss"])
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            if setup:
                self._read_program(k, loss)
            else:
                self.steps.append(time.perf_counter() - t0)
        return loss, time.perf_counter() - t_body

    def _read_program(self, k: int, loss: float):
        from repro_torch import tree as T
        seed, st = self.ctx.seed, self.state
        if k <= self.n_ref:
            self.prog.setdefault("losses", []).append(loss)
        if k == 1:
            b1 = self.opt["betas"][0]
            self.prog["grads"] = leaf_readings(
                seed, slices(T.flatten(st["opt"].mu)), 1.0 / (1.0 - b1))
        if k == self.n_ref:
            self.prog["changes"] = change_readings(
                self.ctx, slices(T.flatten(st["params"])))

    def _inference(self, mol_scores):
        """The example's surrogate inference: a forward pass scores the
        docking results."""
        from repro_torch.models import model as M
        dev, cfg = self.ctx.device, self.ctx.cfg
        toks = torch.as_tensor((np.abs(mol_scores) * 1000).astype(np.int32)
                               % cfg.vocab_size, device=dev).reshape(1, -1)
        pos = torch.arange(toks.shape[1], dtype=torch.int32, device=dev)[None]
        with torch.no_grad():
            logits, _, _ = M.forward(self.state["params"], cfg,
                                     {"tokens": toks, "positions": pos},
                                     mode="train")
        return logits.float().mean(dim=(-1, -2)).cpu().numpy()

    # ------------------------------------------------------------- round
    def _submit_wait(self, descs, stage: str, record: bool):
        tasks = self.tmgr.submit_tasks(descs)
        if not self.tmgr.wait_tasks(tasks, timeout=self.ctx.traffic[
                "stage_timeout_s"]):
            raise TimeoutError(f"{stage} stage exceeded its timeout")
        bad = [(t.uid, t.state.value, t.error) for t in tasks
               if t.state.value != "DONE"]
        if record:
            self.attempted += len(tasks)
            self.failed += len(bad)
        if bad:
            raise RuntimeError(f"{stage} tasks not DONE: {bad}")
        return tasks

    def round(self, setup: bool = False):
        from repro_torch.core.task import TaskDescription
        ctx, spans, record = self.ctx, self.ctx.spans, not setup
        score = altered if ctx.fault == "answer" else docking
        with spans.span("round.docking"):
            dock = self._submit_wait([TaskDescription(
                kind="function", fn=score, args=(m,), stage="docking")
                for m in self.candidates], "docking", record)
        scores = np.asarray([t.result for t in dock])
        self.docked.extend((m, t.result) for m, t in zip(self.candidates,
                                                         dock))
        toks = sst_tokens(self.candidates, self.rng, self.S,
                          ctx.m["vocab_size"])
        if setup:
            self.first_batch = toks
        with spans.span("round.sst_train"):
            train, = self._submit_wait([TaskDescription(
                kind="executable", coupling="tight", fn=self._train_task,
                args=(toks, setup), stage="sst_train")], "sst_train", record)
        with spans.span("round.inference"):
            inf, = self._submit_wait([TaskDescription(
                kind="function", fn=self._inference, args=(scores,),
                stage="inference")], "inference", record)
        with spans.span("round.select"):
            self.candidates = select(self.candidates, scores, self.rng)
        if record:
            L, cfg = ctx.m["num_layers"], ctx.cfg
            runs = 1 if cfg.remat == "none" else 2
            rows = len(toks) if ctx.fault != "half_batch" else len(toks) // 2
            self.work["flash_fwd"] += ([(rows, self.S)]
                                       * (runs * L * self.n_steps)
                                       + [(1, len(scores))] * L)
            self.work["train_steps"] += [(rows, self.S)] * self.n_steps
            for t in dock + [inf]:
                self.tasks.append({"stage": t.description.stage,
                                   "t": dict(t.timestamps)})
            self.tasks.append({"stage": "sst_train",
                               "t": dict(train.timestamps),
                               "body_s": train.result[1],
                               "tokens": self.n_steps * toks.size})

    def window(self, seconds: float):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.round()
        return t0, time.perf_counter()

    def release(self):
        self.session.close()
        self.state.clear()
        self.step = self.session = self.tmgr = None

    # ------------------------------------------------------------- check
    def check(self) -> Dict[str, float]:
        """The reference's first steps on the first round's batch, from the
        same weights, against the program's readings; and every docking
        answer of the run against the scoring run again."""
        ref = reference_readings(self.ctx, self.first_batch, self.opt,
                                 self.n_ref)
        out = compare(self.prog, ref)
        out["wrong_answers"] = float(sum(result != docking(m)
                                         for m, result in self.docked))
        return out


def compare(got: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a run's readings are held to against the reference's:
    the widest gap of a step's loss, and the worst leaf's gaps of the first
    gradient and of the change. A leaf whose reference gradient is under a
    thousandth of the median leaf's moves by round-off alone and is left
    out."""
    med = float(np.median([v[0] for v in ref["grads"].values()]))
    counted = [n for n, v in ref["grads"].items() if v[0] >= 1e-3 * med]
    g = gaps(got["grads"], ref["grads"], counted)
    c = gaps(got["changes"], ref["changes"], counted)
    out = {f"loss_gap_step{i + 1}": float(abs(a - b))
           for i, (a, b) in enumerate(zip(got["losses"], ref["losses"]))}
    out.update({"loss_gap": max(out.values()), "grad_norm_gap": g["norm"],
                "change_norm_gap": c["norm"], "grad_coord_gap": g["coords"],
                "change_coord_gap": c["coords"],
                "leaves_counted": float(len(counted))})
    return out


def change_readings(ctx, named) -> Dict:
    """{name: (norm, coordinates)} of each leaf's change from the weights
    the run started from, made again from the seed a leaf at a time."""
    start, out = {}, {}
    for name, t in named:
        path = name.split(":")[0]
        if path not in start:
            start = {path: weights.make_leaf(ctx.ref, ctx.m, ctx.seed,
                                             path, t.device)}
        p0 = start[path]
        p0 = p0[int(name.split(":")[1])] if ":" in name else p0
        out.update(leaf_readings(ctx.seed, [(name, t.float() - p0.float())]))
    return out


def reference_readings(ctx, tokens_np, opt, steps, prec="fp32", rows=None
                       ) -> Dict:
    """The plain reference's losses, first gradients and changes."""
    dev, m, seed = ctx.device, ctx.m, ctx.seed
    toks = torch.as_tensor(tokens_np, device=dev).long()
    got = {}

    def observe(step, grads, store):
        if step == 1:
            got["grads"] = leaf_readings(seed, grads.items())
        if step == steps:
            got["changes"] = change_readings(ctx, store.items())
    res = ctx.ref.train(m, weights.make(ctx.ref, m, seed, dev), toks, toks,
                        opt, steps, prec, rows, observe)
    got["losses"] = res["losses"]
    return got


def readings(cell, control: bool) -> Dict:
    """For the limits (``bench/calibrate.py``): the program's numbers, and
    with ``control`` those of the reference computed in fp8 in the
    program's place and of the fault that leaves out half of the batch,
    each against the float32 reference. A state left unchanged reads 1 by
    these measures and needs no run."""
    ctx, B = cell.ctx, cell.B
    ref = reference_readings(ctx, cell.first_batch, cell.opt, cell.n_ref)
    out = {"program": compare(cell.prog, ref)}
    if control:
        out["control"] = compare(reference_readings(
            ctx, cell.first_batch, cell.opt, cell.n_ref, "fp8"), ref)
        out["half_batch"] = compare(reference_readings(
            ctx, cell.first_batch, cell.opt, cell.n_ref,
            rows=list(range(B // 2))), ref)
    return out
