"""Frontier-measured service constants, each cited to the paper
(Merzky et al., SC-W'25). These parametrize the discrete-event backend models;
the headline behaviors (50% srun utilization, flux scaling, dragon flatness,
RP dispatch ceiling) are *structural* consequences of caps and queues, not
curve fits — see DESIGN.md §2.1.
"""
from __future__ import annotations

import math

# --- platform ---------------------------------------------------------------
CORES_PER_NODE = 56          # §4.1.1: 4 nodes, SMT=1 -> 224 cores
GPUS_PER_NODE = 8

# --- srun (Slurm) ------------------------------------------------------------
SRUN_CONCURRENCY_CAP = 112   # §4.1.1/Fig.4: system-wide concurrent srun ceiling


def srun_rate(nodes: int) -> float:
    """Central-controller launch rate (tasks/s). §6: 152 t/s at 1 node,
    61 t/s at 4 nodes, declining with scale -> 152 * n^-0.66."""
    return 152.0 * max(1, nodes) ** -0.66


# --- flux ---------------------------------------------------------------------
FLUX_STARTUP_S = 20.0        # Fig. 7: instance bootstrap, scale-independent
FLUX_RATE_MAX = 744.0        # §4.1.2: peak single-instance throughput


def flux_instance_rate(nodes: int) -> float:
    """Single-instance launch rate. §4.1.2: ~28 t/s at 1 node to ~300 t/s avg
    at 1024 nodes (peak 744) -> 28 * n^0.342, capped at the observed peak."""
    return min(FLUX_RATE_MAX, 28.0 * max(1, nodes) ** 0.342)


FLUX_RATE_SIGMA = 0.35       # §4.1.2: "substantial throughput variability"

# --- dragon --------------------------------------------------------------------
DRAGON_STARTUP_S = 9.0       # Fig. 7
DRAGON_RATE_SMALL = 380.0    # §4.1.4: 343-380 t/s at 4-16 nodes (exec tasks)
DRAGON_FUNC_RATE = 900.0     # §4.1.5: native in-memory function mode is ~2x
                             # faster (flux+dragon hits 1547 combined)


def dragon_rate(nodes: int, kind: str = "executable") -> float:
    """Centralized single-instance rate; declines past ~16 nodes
    (§4.1.4: 380 -> 204 t/s at 64 nodes)."""
    base = DRAGON_RATE_SMALL if kind == "executable" else DRAGON_FUNC_RATE
    if nodes <= 16:
        return base
    return base * (16.0 / nodes) ** 0.45


# --- function pool (Raptor/Dragon in-worker function execution) ---------------
# §4.1.5: replacing per-task launch with function dispatch inside persistent
# workers is what lifts rp+flux+dragon to 1,547 t/s combined. Modeled as W
# parallel workers each executing calls at FUNCPOOL_WORKER_RATE; the
# aggregate is structurally capped by the RP dispatch ceiling below, so
# configurations with many workers flatten exactly where the paper does.
FUNCPOOL_WORKER_RATE = 100.0     # calls/s per persistent worker
FUNCPOOL_WORKERS_PER_NODE = 4    # default pool sizing per allocated node
FUNCPOOL_STARTUP_S = 5.0         # pool bring-up (workers spawn once)

# --- RADICAL-Pilot agent ----------------------------------------------------------
RP_DISPATCH_RATE = 1600.0    # §4.1.5: 1547 t/s peak "reflects the current
                             # upper bound of RP's task management subsystem"
RP_DISPATCH_BATCH = 16       # tasks dispatched per agent tick (RP's
                             # task-manager bulk path); the tick is charged
                             # batch/RP_DISPATCH_RATE so the ceiling holds
AGENT_STARTUP_S = 2.0        # pilot bootstrap (small vs Fig.7 runtimes)

# Cross-instance coordination: the paper attributes flux_n's flattening at
# scale to "coordination overhead and ... the overhead of managing many Flux
# instances" (§4.1.3) plus RPC latency growth with allocation size (§4.1.2).
# Modeled as a per-executor serialization stage:
#   coord_rate(nodes, k) = RP_DISPATCH_RATE
#                          / ((1 + nodes/256) * (1 + 0.03*(k-1)))
# which yields ~280 t/s for flux_1@1024 (paper ~300), ~170-230 t/s for
# flux_n@1024/16 (paper 233), and leaves the 64-node flux+dragon
# configuration free to reach the ~1550 t/s RP ceiling (paper 1547).
RP_COORD_NODES = 256.0
RP_COORD_ALPHA = 0.03


def rp_coord_rate(nodes: int, n_instances: int) -> float:
    return RP_DISPATCH_RATE / ((1.0 + nodes / RP_COORD_NODES)
                               * (1.0 + RP_COORD_ALPHA * (n_instances - 1)))

# --- workloads (Table 1) ------------------------------------------------------------
NULL_TASK_S = 0.0
DUMMY_TASK_S = 180.0
DUMMY_LONG_S = 360.0


def tasks_for_nodes(nodes: int, tasks_per_core: int = 4) -> int:
    """Table 1: n_nodes * cpn * 4 single-core tasks."""
    return nodes * CORES_PER_NODE * tasks_per_core
