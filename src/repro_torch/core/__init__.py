"""repro_torch.core — the paper's contribution: a pilot-based multi-runtime
task execution framework (RADICAL-Pilot + Flux + Dragon, SC-W'25), the
port's copy of the JAX package's ``repro.core``.

Public surface:
    SimEngine, RealEngine, Engine         — pluggable execution substrate
    Agent, RoutingPolicy                  — backend-agnostic dispatch pipeline
    Session, PilotManager, TaskManager    — RP-style top-level API
    LocalRuntime                          — compat shim over Session(mode="real")
    Task, TaskDescription, TaskState      — task state machine
    Pilot, PilotDescription, PilotState   — pilot state machine
    Campaign, Stage                       — workflow-of-workflows engine
    make_impeccable_stages, run_impeccable
    compute_metrics, concurrency_series   — paper metrics from event traces

Attributes resolve lazily (PEP 562): ``repro_torch.core`` and
``repro_torch.runtime`` import each other across layers, and deferring the
submodule imports keeps either entry point cycle-free.
"""
import importlib

_EXPORTS = {
    "Agent": "repro_torch.core.agent",
    "AdaptiveRoutingPolicy": "repro_torch.core.agent",
    "RoutingPolicy": "repro_torch.core.agent",
    "SimEngine": "repro_torch.runtime.engine",
    "RealEngine": "repro_torch.runtime.engine",
    "Engine": "repro_torch.runtime.engine",
    "Session": "repro_torch.runtime.session",
    "PilotManager": "repro_torch.runtime.session",
    "TaskManager": "repro_torch.runtime.session",
    "LocalRuntime": "repro_torch.core.local",
    "Task": "repro_torch.core.task",
    "TaskDescription": "repro_torch.core.task",
    "TaskState": "repro_torch.core.task",
    "Pilot": "repro_torch.core.pilot",
    "PilotDescription": "repro_torch.core.pilot",
    "PilotState": "repro_torch.core.pilot",
    "Campaign": "repro_torch.core.campaign",
    "Stage": "repro_torch.core.campaign",
    "StageContext": "repro_torch.core.campaign",
    "make_impeccable_stages": "repro_torch.core.impeccable",
    "run_impeccable": "repro_torch.core.impeccable",
    "RunMetrics": "repro_torch.core.analytics",
    "compute_metrics": "repro_torch.core.analytics",
    "concurrency_series": "repro_torch.core.analytics",
    "FaultMetrics": "repro_torch.core.analytics",
    "fault_metrics": "repro_torch.core.analytics",
    "ChaosController": "repro_torch.faults.chaos",
    "FaultEvent": "repro_torch.faults.chaos",
    "FaultPlan": "repro_torch.faults.chaos",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
