"""Surrogate inference fanned out on Dragon: a closed loop that keeps
``in_flight`` function tasks submitted, each scoring one batch of candidate
sequences with the model's forward (``models.model.forward``).

A task holds ``task_tokens`` tokens: ``B`` sequences of ``L`` with ``B =
task_tokens / L``. The lengths come in blocks that hold each of
``lengths`` ``block_counts`` times, in an order drawn from the seed for
each block, so every seed runs the same set of sizes; the token ids are
uniform over the vocabulary, drawn from the seed and the task's index.
A task's answer is the log-probability of each next token of each of its
sequences, (B, L - 1) in float32, returned to its submitter.

Set-up runs two tasks of each length through the runtime, all at once,
so every worker thread and every shape is warm. The window submits while
its time lasts and ends when the last task begun inside it is done.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from bench import weights

FAULTS = ("half_batch", "answer")


def task_shape(traffic: Dict, seed: int, i: int):
    """(B, L) of task ``i``."""
    lengths, counts = traffic["lengths"], traffic["block_counts"]
    block = [L for L, c in zip(lengths, counts) for _ in range(c)]
    order = np.random.default_rng([abs(seed), i // len(block)]).permutation(
        len(block))
    L = block[order[i % len(block)]]
    return traffic["task_tokens"] // L, L


def task_tokens(traffic: Dict, vocab: int, seed: int, i: int) -> np.ndarray:
    B, L = task_shape(traffic, seed, i)
    rng = np.random.default_rng([abs(seed), 1 << 20, i])
    return rng.integers(0, vocab, size=(B, L), dtype=np.int64)


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tasks: List[Dict] = []
        self.steps: List[float] = []
        self.work: Dict = {"flash_fwd": []}
        self.attempted = self.failed = 0
        self.answers: Dict[int, np.ndarray] = {}

    def setup(self):
        from repro_torch.core.pilot import PilotDescription
        from repro_torch.runtime import PilotManager, Session, TaskManager
        ctx = self.ctx
        self.params = weights.to_program(ctx.cfg, weights.make(
            ctx.ref, ctx.m, ctx.seed, ctx.device))
        self.session = Session(mode="real")
        pilot = PilotManager(self.session).submit_pilots(PilotDescription(
            nodes=1, backends={"dragon": {
                "workers": ctx.traffic["dragon_workers"]}}))
        self.tmgr = TaskManager(self.session)
        self.tmgr.add_pilots(pilot)
        self.engine = self.session.engine
        tr = ctx.traffic
        warm = [toks for L in tr["lengths"] for toks in
                2 * [np.zeros((tr["task_tokens"] // L, L), dtype=np.int64)]]
        tasks = self.tmgr.submit_tasks([self._describe(-1, t) for t in warm])
        if not self.tmgr.wait_tasks(tasks, timeout=tr["task_timeout_s"]):
            raise TimeoutError("the warm-up tasks did not finish")
        bad = [t.error for t in tasks if t.state.value != "DONE"]
        if bad:
            raise RuntimeError(f"warm-up tasks failed: {bad}")

    def _score(self, i: int, tokens: np.ndarray):
        """The payload: one forward of the task's sequences."""
        from repro_torch.models import model as M
        t_body = time.perf_counter()
        dev, cfg = self.ctx.device, self.ctx.cfg
        if self.ctx.fault == "half_batch":
            tokens = tokens[: max(1, len(tokens) // 2)]
        with self.ctx.spans.span("infer.forward"):
            toks = torch.as_tensor(tokens, device=dev)
            B, L = toks.shape
            pos = torch.arange(L, dtype=torch.int32, device=dev)[None].expand(
                B, L)
            with torch.no_grad():
                logits, _, _ = M.forward(self.params, cfg,
                                         {"tokens": toks, "positions": pos},
                                         mode="train")
                lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
                out = lp.gather(-1, toks[:, 1:, None])[..., 0].cpu().numpy()
        if self.ctx.fault == "answer":
            out[0, 0] += 0.5
        return out, time.perf_counter() - t_body

    def _describe(self, i: int, tokens: np.ndarray):
        from repro_torch.core.task import TaskDescription
        return TaskDescription(kind="function", fn=self._score,
                               args=(i, tokens), stage="inference")

    def window(self, seconds: float):
        ctx, tr = self.ctx, self.ctx.traffic
        vocab, depth = ctx.m["vocab_size"], tr["in_flight"]
        inflight, i = [], 0
        t0 = time.perf_counter()
        while True:
            while len(inflight) < depth and time.perf_counter() - t0 < seconds:
                toks = task_tokens(tr, vocab, ctx.seed, i)
                task = self.tmgr.submit_tasks(self._describe(i, toks))
                inflight.append((i, task))
                i += 1
            if not inflight:
                break
            with ctx.spans.span("loop.wait"):
                if not self.engine.drain(lambda: any(t.done for _, t in
                                                     inflight),
                                         timeout=tr["task_timeout_s"]):
                    raise TimeoutError("no task finished within "
                                       f"{tr['task_timeout_s']} s")
            for j, t in [x for x in inflight if x[1].done]:
                self._record(j, t)
            inflight = [x for x in inflight if not x[1].done]
        return t0, time.perf_counter()

    def _record(self, i: int, task):
        self.attempted += 1
        B, L = task_shape(self.ctx.traffic, self.ctx.seed, i)
        if task.state.value != "DONE":
            self.failed += 1
            return
        out, body_s = task.result
        self.answers[i] = out
        self.tasks.append({"stage": "inference", "index": i,
                           "t": dict(task.timestamps), "body_s": body_s,
                           "tokens": B * L, "shape": (B, L)})
        self.work["flash_fwd"] += [(B, L)] * self.ctx.m["num_layers"]

    def release(self):
        self.session.close()
        self.params = self.session = self.tmgr = self.engine = None

    def sample(self) -> List[int]:
        """The tasks the reference checks: ``check_tasks`` of those the
        window completed, drawn from the seed, the first of the longest
        among them."""
        done = sorted(self.answers)
        longest = max(L for _, L in (task_shape(self.ctx.traffic,
                                                self.ctx.seed, i)
                                     for i in done))
        first = next(i for i in done if task_shape(
            self.ctx.traffic, self.ctx.seed, i)[1] == longest)
        rest = [i for i in done if i != first]
        rng = np.random.default_rng([abs(self.ctx.seed), 7])
        n = min(len(rest), self.ctx.traffic["check_tasks"] - 1)
        return [first] + sorted(rng.choice(rest, size=n, replace=False)
                                .tolist())

    def check(self) -> Dict[str, float]:
        """The reference's log-probabilities of the sampled tasks' tokens
        against the answers the tasks returned: the widest gap, and the
        answers of the wrong shape or not finite."""
        ctx, tr = self.ctx, self.ctx.traffic
        ref = ctx.ref
        W = ref.split(weights.make(ref, ctx.m, ctx.seed, ctx.device), ctx.m)
        worst, wrong = 0.0, 0
        for i in self.sample():
            toks = torch.as_tensor(task_tokens(tr, ctx.m["vocab_size"],
                                               ctx.seed, i), device=ctx.device)
            want = ref.token_logprobs(W, ctx.m, toks).cpu().numpy()
            got = self.answers[i]
            if got.shape != want.shape or not np.isfinite(got).all():
                wrong += 1
                continue
            worst = max(worst, float(np.abs(got.astype(np.float64)
                                            - want).max()))
        return {"logprob_gap": worst, "wrong_answers": float(wrong),
                "lost_tasks": float(self.failed)}


def readings(cell, control: bool) -> Dict:
    """For the limits (``bench/calibrate.py``): the program's numbers, and
    with ``control`` the widest gap of the reference computed in fp8, in
    the program's place, on the same sampled tasks."""
    out = {"program": cell.check()}
    if control:
        ctx = cell.ctx
        ref = ctx.ref
        W = ref.split(weights.make(ref, ctx.m, ctx.seed, ctx.device), ctx.m)
        worst = 0.0
        for i in cell.sample():
            toks = torch.as_tensor(task_tokens(ctx.traffic, ctx.m["vocab_size"],
                                               ctx.seed, i), device=ctx.device)
            r32 = ref.token_logprobs(W, ctx.m, toks, "fp32")
            r8 = ref.token_logprobs(W, ctx.m, toks, "fp8")
            worst = max(worst, float((r8 - r32).abs().max()))
        out["control"] = {"logprob_gap": worst}
    return out
