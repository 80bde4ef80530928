"""Partitioning bridge: the paper's Flux partitions realized both as node
ranges (simulation) and as device meshes (real mode) — a tightly coupled
task is co-scheduled onto one partition and receives its mesh
(``repro_torch.launch.mesh.Mesh``) as ``mesh=``.

One of the named differences from the JAX package's copy: JAX carves the
one array of its process's devices; the port's meshes come in kinds
(``launch/mesh.py``), and ``carve_submeshes`` carves each of them (the
local cards, the ranks of a process group, shapes alone)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass
class MeshPartition:
    index: int
    mesh: "repro_torch.launch.mesh.Mesh"          # noqa: F821


def carve_submeshes(mesh, n_partitions: int, axis: str = "data"
                    ) -> List[MeshPartition]:
    """Split a Mesh into disjoint contiguous submeshes along ``axis``.
    Each partition keeps the full extent of every other axis (so tensor
    parallelism inside a partition is untouched).

    A mesh over the local devices (``make_local_mesh``) is carved as JAX
    carves ``mesh.devices``: each partition a local mesh over its slice of
    the device array. A one-process mesh (every axis of size 1, as
    ``make_host_mesh`` gives without a launcher) is one partition, the mesh
    whole, as JAX carves a one-device mesh. A mesh over ranks gives each
    partition a ``DeviceMesh`` over its range of ranks: ``new_group`` is
    collective, so every rank of the mesh calls this and builds every
    partition, in one order (a partition without this rank has no
    coordinate for it). An abstract mesh gives abstract partitions (shapes
    only)."""
    from repro_torch.launch.mesh import Mesh
    idx = mesh.axis_names.index(axis)     # ValueError for an axis it lacks
    size = mesh.shape[axis]
    if mesh.size == 1 and mesh.devices is None:
        return [MeshPartition(0, mesh)]
    n_partitions = min(n_partitions, size)
    step = size // n_partitions
    parts = []
    for i in range(n_partitions):
        lo = i * step
        hi = (i + 1) * step if i < n_partitions - 1 else size
        shape = {**mesh.shape, axis: hi - lo}
        sub = devices = None
        if mesh.devices is not None:
            slicer = [slice(None)] * mesh.devices.ndim
            slicer[idx] = slice(lo, hi)
            devices = mesh.devices[tuple(slicer)]
        elif mesh.device_mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            ranks = mesh.device_mesh.mesh.narrow(idx, lo, hi - lo)
            sub = DeviceMesh(mesh.device_mesh.device_type, ranks,
                             mesh_dim_names=mesh.axis_names)
        parts.append(MeshPartition(i, Mesh(shape, sub, devices)))
    return parts
