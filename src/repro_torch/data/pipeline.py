"""Data pipeline of the port: deterministic synthetic token streams (LM
pretraining shape), host-side sharding, background prefetch, and
checkpointable state.

The port's own copy of the JAX package's ``repro/data/pipeline.py`` (which
imports no JAX, but the port imports nothing of ``repro``). It is numpy only
and draws the same bits: for one seed, step and host both packages give
equal batches, so the two training drivers see the same stream.

Synthetic data is the norm for systems benchmarking; the pipeline is
nonetheless production-shaped: per-host sharding by data-parallel rank,
double-buffered prefetch, and a restorable cursor so checkpoint/restart
resumes the stream exactly.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 1234
    n_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2


class SyntheticTokenStream:
    """Deterministic zipf-ish token stream with a restorable cursor.

    Batches are generated per host: host h of H gets rows
    [h*B/H, (h+1)*B/H) of the global batch, so multi-host training sees one
    coherent global stream."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        if dcfg.global_batch % dcfg.n_hosts:
            raise ValueError(f"global batch {dcfg.global_batch} does not "
                             f"divide over {dcfg.n_hosts} hosts")
        self.cfg = cfg
        self.dcfg = dcfg
        self.step = 0
        self.local_batch = dcfg.global_batch // dcfg.n_hosts

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.dcfg.seed}

    def load_state_dict(self, state: Dict[str, int]):
        if state["seed"] != self.dcfg.seed:
            raise ValueError(f"stream seed mismatch: {state['seed']} != "
                             f"{self.dcfg.seed}")
        self.step = int(state["step"])

    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        d = self.dcfg
        rng = np.random.default_rng(
            np.random.SeedSequence([d.seed, step, d.host_id]))
        B, S = self.local_batch, d.seq_len
        V = self.cfg.vocab_size
        # zipf-flavored marginals: realistic token frequency skew
        z = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
        tokens = (z % (V - 2)) + 1
        batch = {
            "tokens": tokens[:, :S].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }
        if self.cfg.rope_kind == "mrope":
            pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, None],
                                  (3, B, S)).copy()
        else:
            pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None],
                                  (B, S)).copy()
        batch["positions"] = pos
        if self.cfg.input_mode == "embeddings":
            batch["embeds"] = rng.standard_normal(
                (B, S, self.cfg.d_model), dtype=np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self._batch_at(self.step)
        self.step += 1
        return b


class PrefetchingLoader:
    """Background-thread prefetch (double buffering) over any iterator.

    ``close`` stops the thread and joins it: the thread never blocks on a
    full queue for longer than ``_POLL_S`` without looking at the stop
    flag."""

    _POLL_S = 0.05

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self):
        try:
            for item in self._it:
                if not self._put(item):
                    return
        except Exception as e:       # noqa: BLE001  raised by __next__
            self._err = e
        self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        self._thread.join()


def make_loader(cfg: ModelConfig, dcfg: DataConfig) -> SyntheticTokenStream:
    return SyntheticTokenStream(cfg, dcfg)
