"""A rank group over the devices of a local mesh: how a Flux task runs its
step over a partition of several cards.

JAX runs a step over several devices of its one process (a jitted step on
a submesh). The port's data and tensor parallelism run over the ranks of
``torch.distributed``, so a task on a partition of several local devices
(``launch/mesh.make_local_mesh``, carved by ``core/partition.py``) runs in
a group of ranks spawned for it: one process a device, joined into one
process group, each rank calling the task's callable with ``mesh=`` a mesh
over the group's ranks of the partition's shape and axis names
(``make_mesh``).

  * Each rank makes current the device at its own coordinate of
    ``mesh.devices`` (row-major, as ``make_mesh`` lays out the ranks), not
    the card of its rank number: partition 1 of a (2, 2) mesh lies on cards
    2 and 3, and its ranks are 0 and 1 of their own group. The card is
    current (and CUDA up) before the process group and its ``DeviceMesh``
    exist, so that neither picks a card by rank; a rank whose current card
    moved all the same fails.
  * The backend is ``launch/mesh.mesh_backend``'s: NCCL over distinct
    cards, gloo over CPU devices or where a card repeats. A failure of the
    group fails the call; nothing is retried on another backend or on
    fewer devices.
  * Rendezvous through a ``FileStore`` in a fresh temporary directory, so
    that groups started at once never share a port or a store.
  * The kernels are built in the caller before any rank starts, so that
    the ranks load them and never compile them at once.
  * Rank 0's return value comes back, its tensors moved to the host in the
    rank and onto the partition's first device here. Each rank reports its
    device, its current card, its kernel launches (``launches`` and
    ``card_launches`` of each wrapper, counted from 0 around the call) and
    its peak memory.
  * A rank that raises fails the call with its traceback; a rank that
    dies, a deadline that passes or ``RankGroup.kill`` kill every rank.
    The call returns or raises only after every rank has exited.

The callable and its arguments cross to the ranks by pickle, so the
callable is a module-level function: a rank imports its module (which
should not import what a rank does not need, such as JAX).
"""
from __future__ import annotations

import inspect
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

KERNELS = ("flash_attention", "decode_attention", "fused_rmsnorm", "ssd")
ERROR_GRACE_S = 3.0       # after a rank's error, the others' to report theirs
EXIT_GRACE_S = 60.0       # after every report, the ranks' own exit


class RankError(RuntimeError):
    """A rank of the group raised, died, or the group was killed."""


def _map_tensors(obj, fn):
    """``obj`` with every tensor in its dicts, lists and tuples mapped by
    ``fn`` (named tuples keep their type)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return type(obj)((k, _map_tensors(v, fn)) for k, v in obj.items())
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tensors(v, fn) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _kernel_modules():
    import importlib
    return {name: importlib.import_module(f"repro_torch.kernels.{name}.ops")
            for name in KERNELS}


def _rank_main(rank, world, devices, shape, axes, backend, store_path,
               payload, results):
    """One rank: its card current, the process group joined, the callable
    run with the rank mesh; every message to the parent flushed before
    the process group is torn down."""
    msg = None
    joined = False
    try:
        import torch.distributed as dist
        dev = devices[rank]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.cuda.init()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        dist.init_process_group(backend, store=dist.FileStore(store_path,
                                                              world),
                                rank=rank, world_size=world)
        joined = True
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(shape, axes, device=dev)
        current = torch.cuda.current_device() if dev.type == "cuda" else None
        if current not in (None, dev.index):
            raise RuntimeError(f"rank {rank} moved to card {current}, not "
                               f"its partition's {dev}")
        results.put(("ready", rank, time.monotonic()))
        fn, args, kwargs = pickle.loads(payload)
        mods = _kernel_modules()
        for mod in mods.values():
            mod.launches, mod.card_launches = 0, {}
        t0 = time.monotonic()
        out = fn(*args, mesh=mesh, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.monotonic()
        report = {
            "rank": rank, "device": str(dev), "pid": os.getpid(),
            "current": (torch.cuda.current_device() if dev.type == "cuda"
                        else None),
            "launches": {n: m.launches for n, m in mods.items()},
            "card_launches": {n: dict(m.card_launches)
                              for n, m in mods.items()},
            "split_launches": mods["fused_rmsnorm"].split_launches,
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
            "t0": t0, "t1": t1}
        value = (pickle.dumps(_map_tensors(out, lambda t: t.detach().cpu()))
                 if rank == 0 else None)
        msg = ("done", rank, report, value)
    except BaseException:                                 # noqa: BLE001
        msg = ("error", rank, traceback.format_exc())
    results.put(msg)
    results.close()
    results.join_thread()           # flushed before a kill could cut it
    if joined:
        import torch.distributed as dist
        dist.destroy_process_group()


def _accepts_mesh(fn) -> bool:
    try:
        return "mesh" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


class RankGroup:
    """The ranks of one call of ``fn`` over the local ``mesh`` (see the
    module docstring): ``run`` spawns them and returns rank 0's value;
    ``kill`` ends them from another thread. After ``run``, ``ranks`` holds
    each rank's report, ``spawn_s`` the seconds from the first spawn until
    every rank had its card and its process group, and ``wall_s`` the
    seconds of the whole call."""

    def __init__(self, mesh, fn, args=(), kwargs=None):
        from repro_torch.launch.mesh import mesh_backend
        if getattr(mesh, "devices", None) is None:
            raise ValueError(f"{mesh!r} is not a local mesh: a rank group "
                             f"spans a local mesh's devices")
        if not _accepts_mesh(fn):
            raise TypeError(f"{getattr(fn, '__name__', fn)!r} takes no mesh="
                            f": each rank passes it the rank mesh")
        self.mesh = mesh
        self.devices = list(mesh.devices.flat)
        self.backend = mesh_backend(mesh)
        try:
            self._payload = pickle.dumps((fn, tuple(args), dict(kwargs or {})))
        except Exception as e:                            # noqa: BLE001
            raise TypeError(f"a rank group's callable and arguments cross to "
                            f"the ranks by pickle (a module-level function): "
                            f"{getattr(fn, '__qualname__', fn)!r} is not "
                            f"picklable ({type(e).__name__}: {e})") from None
        self.ranks: List[Dict[str, Any]] = []
        self.pids: List[int] = []
        self.spawn_s: Optional[float] = None
        self.wall_s: Optional[float] = None
        self._lock = threading.Lock()
        self._procs: List[mp.Process] = []
        self._killed: Optional[str] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    def kill(self, reason: str = "killed"):
        """Kill every rank (now, or as it starts); ``run`` then raises
        RankError naming ``reason`` once they have all exited."""
        with self._lock:
            if self._killed is None:
                self._killed = reason
            procs = list(self._procs)
        for p in procs:
            if p.is_alive():
                p.kill()

    def summary(self) -> Dict[str, Any]:
        """What a caller records of the group: backend, devices, spawn and
        wall seconds, pids and each rank's report."""
        return {"backend": self.backend, "devices": [str(d) for d in
                                                     self.devices],
                "spawn_s": self.spawn_s, "wall_s": self.wall_s,
                "pids": list(self.pids), "ranks": list(self.ranks)}

    def run(self, timeout: Optional[float] = None):
        """Spawn the ranks, wait for them and return rank 0's value (its
        tensors on the mesh's first device). Raises RankError where a rank
        raised (its traceback in the message), died, or the deadline
        ``timeout`` (seconds, None for none) or a ``kill`` came first."""
        if any(d.type == "cuda" for d in self.devices):
            from repro_torch.kernels import _build
            _build.build_all()
        ctx = mp.get_context("spawn")     # the caller may have CUDA up
        results = ctx.Queue()
        store = tempfile.mkdtemp(prefix="rank-group-")
        shape = tuple(self.mesh.shape.values())
        world = self.size
        t_start = time.monotonic()
        deadline = None if timeout is None else t_start + timeout
        reports: Dict[int, Dict[str, Any]] = {}
        errors: List[str] = []
        ready, value = set(), None
        try:
            with self._lock:
                for rank in range(world):
                    if self._killed is not None:
                        break
                    p = ctx.Process(
                        target=_rank_main, daemon=True,
                        args=(rank, world, self.devices, shape,
                              self.mesh.axis_names, self.backend,
                              os.path.join(store, "store"), self._payload,
                              results))
                    p.start()
                    self._procs.append(p)
                    self.pids.append(p.pid)
            print(f"[ranks] {world} ranks over {self.backend} on "
                  f"{[str(d) for d in self.devices]} ({self.mesh.shape})",
                  flush=True)
            grace, why = None, None
            while len(reports) < world and self._killed is None:
                try:
                    msg = results.get(timeout=0.2)
                except queue.Empty:
                    now = time.monotonic()
                    if grace is not None and now > grace:
                        break
                    if deadline is not None and now > deadline:
                        why = f"the deadline of {timeout} s passed"
                        break
                    if grace is None and any(
                            p.exitcode is not None and r not in reports
                            for r, p in enumerate(self._procs)):
                        grace = now + 1.0     # its last message may be late
                    continue
                kind, rank = msg[0], msg[1]
                if kind == "ready":
                    ready.add(rank)
                    if len(ready) == world:
                        self.spawn_s = msg[2] - t_start
                elif kind == "done":
                    reports[rank] = msg[2]
                    if rank == 0:
                        value = msg[3]
                else:
                    errors.append(f"rank {rank} of {world} on "
                                  f"{self.devices[rank]}:\n{msg[2]}")
                    reports[rank] = {"rank": rank, "error": msg[2]}
                    if grace is None:
                        grace = time.monotonic() + ERROR_GRACE_S
            missing = [r for r in range(world) if r not in reports]
            if missing and self._killed is None:
                codes = [self._procs[r].exitcode if r < len(self._procs)
                         else None for r in missing]
                errors.append(f"ranks {missing} gave no result (exit codes "
                              f"{codes})" + (f": {why}" if why else ""))
        finally:
            clean = not errors and self._killed is None
            end = time.monotonic() + (EXIT_GRACE_S if clean else 0.0)
            for p in self._procs:
                p.join(timeout=max(0.0, end - time.monotonic()))
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
            results.cancel_join_thread()
            shutil.rmtree(store, ignore_errors=True)
            self.ranks = [reports[r] for r in sorted(reports)]
            self.wall_s = time.monotonic() - t_start
        if self._killed is not None:
            raise RankError(f"rank group on {[str(d) for d in self.devices]} "
                            f"killed: {self._killed}")
        if errors:
            raise RankError("\n".join(errors))
        first = self.devices[0]
        return _map_tensors(pickle.loads(value), lambda t: t.to(first))


def run_on_mesh(mesh, fn, *args, timeout: Optional[float] = None, **kwargs):
    """``fn(*args, mesh=rank_mesh, **kwargs)`` on a group of ranks spawned
    over the devices of the local ``mesh``, one a device (see the module
    docstring); returns rank 0's value. ``fn`` is a module-level function;
    ``timeout`` a deadline in seconds for the whole call."""
    return RankGroup(mesh, fn, args, kwargs).run(timeout=timeout)
