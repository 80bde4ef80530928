"""Resource bookkeeping: nodes with cores/GPUs, allocations, partitions.

The same ``NodePool`` serves the simulator (Frontier-like nodes) and real mode
(host cores / CUDA device meshes mapped to abstract nodes). Invariant (tested with
hypothesis): free counts never go negative and alloc/free round-trips restore
them exactly — no oversubscription ever.

Gang reservations (``claim``/``claim_ready``/``alloc_claimed``) support
conservative backfill: a blocked multi-node task claims a set of nodes that
then stop accepting new allocations and drain toward fully-free, bounding the
gang's wait by the residual work on the claimed nodes instead of letting a
stream of small tasks starve it forever.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.task import TaskDescription


@dataclass(frozen=True)
class NodeSpec:
    cores: int = 56          # Frontier compute node (usable cores, SMT=1)
    gpus: int = 8            # logical GPUs (GCDs)


@dataclass
class Allocation:
    """cores/gpus taken per node index."""
    node_cores: Dict[int, int] = field(default_factory=dict)
    node_gpus: Dict[int, int] = field(default_factory=dict)
    # set by NodePool.free: an allocation may be returned exactly once.
    # Chaos can race a task failure against its launch server's release;
    # the second free of the same handle must not re-credit the pool.
    freed: bool = False

    @property
    def total_cores(self) -> int:
        return sum(self.node_cores.values())


class DoubleFreeError(RuntimeError):
    """An Allocation was returned to a NodePool twice."""


class NodeClaim:
    """A reservation over specific nodes: they accept no new allocations and
    drain toward fully-free, at which point ``alloc_claimed`` hands the whole
    set to the claiming gang atomically."""

    __slots__ = ("want", "nodes")

    def __init__(self, want: int, nodes: List[int]):
        self.want = want
        self.nodes = nodes


class NodePool:
    """First-fit allocator over a contiguous node range."""

    def __init__(self, n_nodes: int, spec: NodeSpec = NodeSpec(),
                 first_node: int = 0):
        self.spec = spec
        self.n_nodes = n_nodes
        self.first_node = first_node
        self.free_cores: Dict[int, int] = {
            first_node + i: spec.cores for i in range(n_nodes)}
        self.free_gpus: Dict[int, int] = {
            first_node + i: spec.gpus for i in range(n_nodes)}
        # nodes held by an active NodeClaim: excluded from every alloc path
        # until the claim launches (alloc_claimed) or is released
        self.held: Set[int] = set()
        # nodes removed by fault injection: their capacity is gone for good
        # and frees targeting them are silently dropped
        self.lost: Set[int] = set()
        self.double_frees = 0

    # ------------------------------------------------------------------ alloc
    def can_fit(self, td: TaskDescription) -> bool:
        return self._try_alloc(td, commit=False) is not None

    def alloc(self, td: TaskDescription) -> Optional[Allocation]:
        return self._try_alloc(td, commit=True)

    def _try_alloc(self, td: TaskDescription, commit: bool
                   ) -> Optional[Allocation]:
        held = self.held
        if td.nodes:
            # whole-node co-scheduling (claimed nodes are off limits: they
            # belong to the reservation that is draining them)
            empty = [n for n, c in self.free_cores.items()
                     if c == self.spec.cores and
                     self.free_gpus[n] == self.spec.gpus and n not in held]
            if len(empty) < td.nodes:
                return None
            alloc = Allocation()
            for n in sorted(empty)[: td.nodes]:
                alloc.node_cores[n] = self.spec.cores
                alloc.node_gpus[n] = self.spec.gpus
            if commit:
                self._commit(alloc)
            return alloc
        # packed cores/gpus (may not span nodes for simplicity: per-node fit)
        need_c, need_g = td.cores, td.gpus
        if need_c == 1 and need_g == 0:
            # fast path: the paper's dominant load is 1-core 0-gpu tasks;
            # first-fit reduces to "first node with a free core"
            free_cores = self.free_cores
            for n, c in free_cores.items():
                if c > 0 and (not held or n not in held):
                    if commit:
                        free_cores[n] = c - 1
                    return Allocation(node_cores={n: 1})
            return None
        alloc = Allocation()
        # node ids are inserted ascending at construction and never removed,
        # so plain dict order IS first-fit order — no per-alloc sort
        for n in self.free_cores:
            if need_c <= 0 and need_g <= 0:
                break
            if held and n in held:
                continue
            c = min(self.free_cores[n], need_c)
            g = min(self.free_gpus[n], need_g)
            if td.cores <= self.spec.cores and c < td.cores and c < need_c:
                # single-node task must fit one node
                if self.free_cores[n] < td.cores or self.free_gpus[n] < td.gpus:
                    continue
            if c > 0 or g > 0:
                if c:
                    alloc.node_cores[n] = c
                    need_c -= c
                if g:
                    alloc.node_gpus[n] = g
                    need_g -= g
        if need_c > 0 or need_g > 0:
            return None
        if commit:
            self._commit(alloc)
        return alloc

    # ----------------------------------------------------------- reservations
    def claim(self, want: int) -> Optional[NodeClaim]:
        """Reserve ``want`` nodes for a blocked gang: prefer nodes that are
        already (or nearly) drained so the reservation becomes launchable as
        fast as possible. Claimed nodes accept no new allocations. Returns
        None when fewer than ``want`` unclaimed nodes exist at all."""
        held = self.held
        candidates = [n for n in self.free_cores if n not in held]
        if len(candidates) < want:
            return None
        candidates.sort(key=lambda n: (-self.free_cores[n],
                                       -self.free_gpus[n], n))
        nodes = candidates[:want]
        held.update(nodes)
        return NodeClaim(want, nodes)

    def claim_ready(self, c: NodeClaim) -> bool:
        """True once every claimed node has fully drained. A claim that lost
        one of its nodes to a fault can never become ready — the caller must
        release it and re-place."""
        cores, gpus = self.spec.cores, self.spec.gpus
        fc = self.free_cores
        return all(n in fc and fc[n] == cores and self.free_gpus[n] == gpus
                   for n in c.nodes)

    def alloc_claimed(self, td: TaskDescription, c: NodeClaim
                      ) -> Allocation:
        """Atomically hand the claimed node set to the gang (the claim must
        be ready). Releases the hold as part of the allocation."""
        assert td.nodes <= c.want and self.claim_ready(c), "claim not ready"
        alloc = Allocation()
        for n in sorted(c.nodes)[: td.nodes]:
            alloc.node_cores[n] = self.spec.cores
            alloc.node_gpus[n] = self.spec.gpus
        self.held.difference_update(c.nodes)
        c.nodes = []
        self._commit(alloc)
        return alloc

    def release_claim(self, c: NodeClaim):
        self.held.difference_update(c.nodes)
        c.nodes = []

    def _commit(self, alloc: Allocation):
        for n, c in alloc.node_cores.items():
            self.free_cores[n] -= c
            assert self.free_cores[n] >= 0, "core oversubscription"
        for n, g in alloc.node_gpus.items():
            self.free_gpus[n] -= g
            assert self.free_gpus[n] >= 0, "gpu oversubscription"

    def free(self, alloc: Allocation):
        if alloc.freed:
            self.double_frees += 1
            raise DoubleFreeError("allocation already freed")
        alloc.freed = True
        lost = self.lost
        for n, c in alloc.node_cores.items():
            if lost and n in lost:
                continue                       # capacity died with the node
            self.free_cores[n] += c
            assert self.free_cores[n] <= self.spec.cores, "double free"
        for n, g in alloc.node_gpus.items():
            if lost and n in lost:
                continue
            self.free_gpus[n] += g
            assert self.free_gpus[n] <= self.spec.gpus, "double free"

    # ------------------------------------------------------------------ faults
    def remove_node(self, node: Optional[int] = None) -> Optional[int]:
        """Permanently remove a node from the pool (fault injection, or a
        placement view mirroring one). When ``node`` is None the most-idle
        unclaimed node is chosen — placement views track capacity, not
        identity, so an idle stand-in keeps outstanding charges intact.
        Outstanding allocations touching the node are NOT fixed up here —
        callers fail the affected tasks, and :meth:`free` drops the lost
        node's share when those allocations come back. Returns the removed
        node id, or None when the pool is empty."""
        fc = self.free_cores
        if node is None:
            candidates = [n for n in fc if n not in self.held] or list(fc)
            if not candidates:
                return None
            node = max(candidates, key=lambda n: (fc[n], -n))
        elif node not in fc:
            return None
        del self.free_cores[node]
        del self.free_gpus[node]
        self.lost.add(node)
        self.held.discard(node)
        self.n_nodes -= 1
        return node

    # ------------------------------------------------------------------ stats
    @property
    def total_cores(self) -> int:
        return self.n_nodes * self.spec.cores

    @property
    def total_gpus(self) -> int:
        return self.n_nodes * self.spec.gpus

    @property
    def free_whole_nodes(self) -> int:
        """Fully-free, unclaimed nodes — the gang-placement probe."""
        held = self.held
        cores, gpus = self.spec.cores, self.spec.gpus
        return sum(1 for n, c in self.free_cores.items()
                   if c == cores and self.free_gpus[n] == gpus
                   and n not in held)

    @property
    def used_cores(self) -> int:
        return self.total_cores - sum(self.free_cores.values())

    @property
    def used_gpus(self) -> int:
        return self.total_gpus - sum(self.free_gpus.values())


def partition_nodes(n_nodes: int, n_partitions: int,
                    spec: NodeSpec = NodeSpec()) -> List[NodePool]:
    """Split an allocation into disjoint contiguous partitions (the Flux-
    instance layout). Remainder nodes go to the last partition."""
    assert 1 <= n_partitions <= n_nodes
    base = n_nodes // n_partitions
    pools = []
    start = 0
    for i in range(n_partitions):
        size = base + (n_nodes - base * n_partitions if i == n_partitions - 1
                       else 0)
        pools.append(NodePool(size, spec, first_node=start))
        start += size
    return pools
