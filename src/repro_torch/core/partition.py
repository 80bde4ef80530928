"""Partitioning bridge: the paper's Flux partitions realized both as node
ranges (simulation) and as device meshes (real mode) — a tightly coupled
task is co-scheduled onto one partition and receives its mesh
(``repro_torch.launch.mesh.Mesh``) as ``mesh=``."""
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

    A one-process mesh (every axis of size 1, as ``make_host_mesh`` gives
    without a launcher) is one partition, the mesh whole, as JAX carves a
    one-device mesh. A mesh over several ranks would need a ``DeviceMesh``
    over each range of ranks, built collectively by every rank: not done
    (ROADMAP item 12b)."""
    mesh.axis_names.index(axis)     # ValueError for an axis it lacks
    if mesh.size > 1:
        raise NotImplementedError(
            f"carving {mesh!r} along {axis!r}: a mesh over several ranks is "
            f"not carved into partitions yet (ROADMAP item 12b)")
    return [MeshPartition(0, mesh)]
