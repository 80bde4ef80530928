"""Fault injection and recovery characterization for the task runtime."""
from repro_torch.faults.chaos import ChaosController, FaultEvent, FaultPlan

__all__ = ["ChaosController", "FaultEvent", "FaultPlan"]
