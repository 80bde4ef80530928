"""Checkpointing in the JAX package's on-disk format
(``repro/checkpoint/checkpoint.py``), so a checkpoint written by either
package restores into the other:

  <dir>/step_%08d/arrays.npz      every tensor leaf, keyed by its tree path
                                  with '/' written as '__'; bf16 stored as
                                  uint16 with the dtype tagged "bfloat16"
  <dir>/step_%08d/manifest.json   step, time, meta, and each array's shape
                                  and dtype

A step is written into ``step_%08d.tmp`` and renamed when complete (atomic);
the newest ``keep`` steps are kept. With ``async_save`` the tensors are
copied to host numpy arrays first, then a thread writes them while training
goes on; ``wait`` joins it. Tree paths are those of ``repro_torch.tree``
(JAX's ``tree_flatten_with_path`` for the same tree).

The reference's elastic restore (re-sharding onto another mesh) has no
counterpart on one card: ``restore`` puts each tensor on its template
leaf's device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as T


def _to_host(leaf):
    """A tensor as (a numpy copy, dtype name), bf16 as its uint16 bits;
    anything else as it is. A copy even on the CPU: the caller may write
    the tensor while the save thread runs."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    t = leaf.detach().to("cpu", memory_format=torch.contiguous_format,
                         copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, Any],
             extra_meta: Optional[Dict[str, Any]] = None):
        """``state``: trees of tensors (params, OptState) and small
        JSON-ables, which go to the manifest's meta. Writes
        <dir>/step_<n>.tmp, then renames it."""
        host = [(key, _to_host(leaf)) for key, leaf in T.flatten(state)]
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra_meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extra_meta)

    def _write(self, step: int, host, extra_meta):
        tmp = os.path.join(self.directory, f"step_{step:08d}.tmp")
        final = os.path.join(self.directory, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(),
                    "meta": dict(extra_meta or {}), "arrays": {}}
        packed = {}
        for key, leaf in host:
            if not isinstance(leaf, tuple):
                manifest["meta"][key] = leaf
                continue
            a, dtype = leaf
            manifest["arrays"][key] = {"shape": list(a.shape), "dtype": dtype}
            packed[key.replace("/", "__")] = a
        np.savez(os.path.join(tmp, "arrays.npz"), **packed)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        return sorted(int(name.split("_")[1])
                      for name in os.listdir(self.directory)
                      if name.startswith("step_") and not name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                template: Optional[Any] = None) -> Dict[str, Any]:
        """{'step', 'meta', 'get(key)'} (``get`` gives a CPU tensor) or, with
        ``template``, {'step', 'meta', 'tree'}: the template's structure with
        each tensor leaf read from the checkpoint onto the template leaf's
        device (shape and dtype must match)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            arrays = {k: data[k] for k in data.files}

        def get(key: str) -> torch.Tensor:
            a = arrays[key.replace("/", "__")]
            if manifest["arrays"][key]["dtype"] == "bfloat16":
                return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            return torch.from_numpy(a)

        if template is None:
            return {"step": step, "meta": manifest["meta"], "get": get}
        leaves = []
        for key, leaf in T.flatten(template):
            t = get(key)
            if tuple(t.shape) != tuple(leaf.shape) or t.dtype != leaf.dtype:
                raise ValueError(f"{key}: checkpoint {t.dtype} "
                                 f"{tuple(t.shape)}, template {leaf.dtype} "
                                 f"{tuple(leaf.shape)}")
            leaves.append(t.to(leaf.device))
        return {"step": step, "meta": manifest["meta"],
                "tree": T.unflatten(template, leaves)}
