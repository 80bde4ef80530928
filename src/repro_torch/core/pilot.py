"""Pilot abstraction: a resource placeholder with its own state machine
(NEW -> LAUNCHING -> ACTIVE -> DONE/FAILED/CANCELED), decoupling resource
acquisition from task execution (the pilot paradigm, §3)."""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, Optional

from repro_torch.core.resources import NodeSpec
from repro_torch.core.task import new_uid


class PilotState(str, Enum):
    NEW = "NEW"
    LAUNCHING = "LAUNCHING"
    ACTIVE = "ACTIVE"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELED = "CANCELED"


_LEGAL = {
    PilotState.NEW: {PilotState.LAUNCHING, PilotState.CANCELED},
    PilotState.LAUNCHING: {PilotState.ACTIVE, PilotState.FAILED,
                           PilotState.CANCELED},
    PilotState.ACTIVE: {PilotState.DONE, PilotState.FAILED,
                        PilotState.CANCELED},
    PilotState.DONE: set(), PilotState.FAILED: set(),
    PilotState.CANCELED: set(),
}


@dataclass
class PilotDescription:
    nodes: int
    runtime_s: float = 24 * 3600.0
    node_spec: NodeSpec = field(default_factory=NodeSpec)
    backends: Dict[str, Dict[str, Any]] = field(
        default_factory=lambda: {"srun": {}})
    uid: str = ""

    def __post_init__(self):
        if not self.uid:
            self.uid = new_uid("pilot")


class Pilot:
    def __init__(self, description: PilotDescription):
        self.description = description
        self.uid = description.uid
        self.state = PilotState.NEW
        self.timestamps: Dict[str, float] = {}

    def advance(self, state: PilotState, t: float, profiler=None):
        if state not in _LEGAL[self.state]:
            raise RuntimeError(f"pilot {self.uid}: illegal "
                               f"{self.state.value} -> {state.value}")
        self.state = state
        self.timestamps[state.value] = t
        if profiler is not None:
            profiler.record(t, self.uid, f"pilot:{state.value}", {})
