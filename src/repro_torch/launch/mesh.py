"""Meshes of the port: named axes over the ranks of ``torch.distributed``,
the counterpart of the JAX package's ``repro/launch/mesh.py``.

A ``Mesh`` is what the sharding rules (``distributed/sharding.py``) and the
data-parallel reduction (``distributed/compression.py``) read: axis names
and sizes (``shape``, a dict in axis order, as ``jax.sharding.Mesh.shape``),
this rank's coordinate, and the process group of a set of axes. Four kinds:

  * over the ranks of a process group: ``torch.distributed``'s
    ``DeviceMesh`` underneath (``make_mesh``, ``make_host_mesh`` under a
    launcher such as ``torchrun``);
  * one process, no process group: every axis of size 1, no collective ever
    runs (``make_host_mesh`` without a launcher);
  * local: the devices of this process (``make_local_mesh``), in an array
    of the mesh's shape, ``devices``, as ``jax.sharding.Mesh.devices``. It
    is what Flux partitions are carved from: each partition a range of
    cards. A task on a partition of one card runs in its worker thread,
    placed on its card (``Mesh.placement``); a step over several of its
    devices runs in a group of ranks spawned over them, one a device
    (``launch/ranks.run_on_mesh``), each with a mesh over the group's
    ranks. A local mesh has no process groups of its own;
  * abstract: axis names and sizes with no ranks, for computing the specs of
    the production meshes (``abstract_mesh``, as JAX's ``AbstractMesh``;
    ``make_production_mesh``).

JAX's ``make_host_mesh`` spans the local devices of its one process. The
port splits that role in two: ``make_host_mesh`` spans the ranks (one
process without a launcher is the (1, 1) mesh that ``train()``,
``generate(mesh=)`` and the CLIs take), ``make_local_mesh`` the cards.

The backend is the caller's: NCCL for a mesh on the card, gloo on the CPU.
Nothing switches between them on its own. A rank group over a local mesh
takes ``mesh_backend``'s: NCCL where the mesh's devices are distinct cards,
gloo where they are CPU devices or where a card repeats (ranks sharing one
card, which NCCL refuses).
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


class Mesh:
    """Named axes (``shape``: name -> size, in axis order) over the ranks of
    ``device_mesh``, over the local ``devices`` (an array of the mesh's
    shape), or over no ranks when both are None (see the module
    docstring)."""

    def __init__(self, shape: Dict[str, int], device_mesh=None,
                 devices: Optional[np.ndarray] = None):
        self.shape = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.device_mesh = device_mesh
        if devices is not None and devices.shape != tuple(self.shape.values()):
            raise ValueError(f"devices {devices.shape} do not match the mesh "
                             f"{self.shape}")
        self.devices = devices
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        kind = ("local" if self.devices is not None
                else "abstract" if self.device_mesh is None and self.size > 1
                else "ranks")
        return f"Mesh({self.shape}, {kind})"

    @property
    def device(self) -> torch.device:
        """The one device of a one-device local mesh; raises for any other
        mesh."""
        if self.devices is None or self.size != 1:
            raise ValueError(f"{self!r} is not a local mesh of one device")
        return self.devices.flat[0]

    def placement(self):
        """A context that makes this local mesh's device (its first, where
        it has several) current on the calling thread, so that
        ``device="cuda"``, ``.cuda()`` and the kernels inside land on it:
        ``torch.cuda.device`` for a card, nothing for the CPU or a mesh of
        ranks."""
        if self.devices is None:
            return contextlib.nullcontext()
        dev = self.devices.flat[0]
        if dev.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(dev)

    def coordinate(self) -> Dict[str, int]:
        """This rank's index along every axis."""
        if self.device_mesh is None:
            if self.size > 1:
                raise RuntimeError(f"{self!r} has no ranks")
            return {a: 0 for a in self.axis_names}
        coord = self.device_mesh.get_coordinate()
        if coord is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in {self!r}")
        return dict(zip(self.axis_names, coord))

    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def axes_index(self, axes: Sequence[str]) -> int:
        """This rank's index over ``axes`` flattened in the order given
        (row-major, the first axis the slowest), as a PartitionSpec entry
        naming several axes lays out its shards."""
        coord, idx = self.coordinate(), 0
        for a in axes:
            idx = idx * self.shape[a] + coord[a]
        return idx

    def group(self, axes: Sequence[str]):
        """The process group over ``axes`` (the ranks that share every other
        coordinate), or None when ``axes`` span one rank."""
        live = tuple(a for a in axes if self.shape[a] > 1)
        if not live:
            return None
        if self.device_mesh is None:
            raise RuntimeError(f"{self!r} has no process groups")
        if len(live) == 1:
            return self.device_mesh.get_group(live[0])
        if (set(live) == {a for a, n in self.shape.items() if n > 1}
                and self.size == dist.get_world_size()):
            return dist.group.WORLD
        if live not in self._groups:
            self._groups[live] = self._new_groups(live)
        return self._groups[live]

    def _new_groups(self, axes: Tuple[str, ...]):
        """This rank's group over several ``axes`` (in axis order) of a
        larger mesh. ``new_group`` is collective: every rank creates every
        group over those axes, in one order."""
        if list(axes) != sorted(axes, key=self.axis_names.index):
            raise ValueError(f"axes {axes} are not in the order of "
                             f"{self.axis_names}")
        ranks = self.device_mesh.mesh
        rest = [i for i, a in enumerate(self.axis_names) if a not in axes]
        perm = rest + [self.axis_names.index(a) for a in axes]
        mine, me = None, dist.get_rank()
        for row in ranks.permute(perm).reshape(-1, self.axes_size(axes)
                                               ).tolist():
            group = dist.new_group(row)
            if me in row:
                mine = group
        return mine


def abstract_mesh(**axes: int) -> Mesh:
    """Axis names and sizes with no ranks: ``abstract_mesh(data=16,
    model=16)``."""
    return Mesh(axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 (data, model) or 2x16x16 (pod, data, model), abstract: the
    production meshes whose specs and costs the dry-run computes. No process
    group is created."""
    if multi_pod:
        return abstract_mesh(pod=2, data=16, model=16)
    return abstract_mesh(data=16, model=16)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device="cuda") -> Mesh:
    """A mesh of ``shape`` over the first prod(shape) ranks of the process
    group; raises when the world is smaller. A one-rank mesh needs no
    process group."""
    n = math.prod(shape)
    world = _world()
    if world < n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, have {world}")
    if not dist.is_initialized():
        return Mesh(dict(zip(axes, shape)))
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    ranks = torch.arange(n).reshape(shape)
    return Mesh(dict(zip(axes, shape)),
                DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axes)))


def _join_launcher(device):
    """Join the process group a launcher describes (``torchrun`` sets
    ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), unless
    one is joined already: NCCL for the card, each rank on card
    ``LOCAL_RANK``; gloo on the CPU."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")


def make_local_mesh(model_parallel: int = 1, *, device="cuda",
                    devices: Optional[Sequence] = None) -> Mesh:
    """A (n / mp, mp) mesh of axes ("data", "model") over the local devices
    of this process, in order: the ``torch.cuda.device_count()`` cards (for
    ``device="cuda"``), or ``devices`` where given (the CPU tests pass a
    list of CPU devices). A card may be listed more than once: a partition
    of it then runs its ranks on one card, over gloo (``mesh_backend``).
    Raises where mp does not divide n."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"make_local_mesh spans the local cards; pass "
                             f"devices= for {dev}")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if any(d.type == "cuda" and d.index is None for d in devices):
        raise ValueError(f"name each card of a local mesh by its index: "
                         f"{devices}")
    n = len(devices)
    if n == 0 or n % model_parallel:
        raise ValueError(f"{n} devices do not split into model parallel "
                         f"{model_parallel}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    shape = (n // model_parallel, model_parallel)
    return Mesh(dict(zip(("data", "model"), shape)),
                devices=arr.reshape(shape))


def mesh_backend(mesh) -> str:
    """The process group backend of a rank group over the local ``mesh``:
    "nccl" where its devices are distinct cards, "gloo" where they are CPU
    devices or where a card repeats. Raises for a mesh of both."""
    devices = list(mesh.devices.flat)
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"a rank group spans CPU devices or cards, not "
                         f"{sorted(map(str, devices))}")
    return "nccl" if len({d.index for d in devices}) == len(devices) \
        else "gloo"


def make_host_mesh(model_parallel: int = 1, *, device="cuda") -> Mesh:
    """A (world / mp, mp) mesh of axes ("data", "model") over the ranks that
    exist, joining a launcher's process group first: (1, 1) in one process
    without a launcher."""
    _join_launcher(device)
    n = _world()
    mp = min(model_parallel, n)
    return make_mesh((n // mp, mp), ("data", "model"), device=device)

