"""Trace-native observability for the runtime (paper §4 methodology):
post-hoc lifecycle decomposition, reconstructed timeseries, Chrome/Perfetto
trace export, and the unified :class:`RunReport` — all derived from the
columnar event trace and task columns after the run, so the hot path pays
nothing beyond the appends it already makes — plus the streaming layer
(:mod:`repro_torch.observability.stream`): O(Δ) trace cursors, incremental
aggregators that reconcile with the post-hoc pass at drain, online health
alerts, and the ``watch`` live dashboard — and the program's own spans
(:mod:`repro_torch.core.spans`, exported here as ``spans``: the train
step's parts and each task's payload, off by default, on the clock of the
task stamps).

See ``python -m repro_torch.observability --help`` for the CLI and
the JAX package's src/repro/runtime/README.md ("Observability") for the
tour.
"""
from repro_torch.observability.lifecycle import (
    GroupBreakdown, LifecycleBreakdown, PHASES, PhaseStats,
    lifecycle_breakdown)
from repro_torch.observability.timeseries import (
    METRICS, Series, backend_inflight, inflight, occupancy, sched_hold_depth,
    service_queue_depth, throughput, timeseries)
from repro_torch.observability.stream import (
    ALERT_EVENT, Alert, HealthMonitor, HealthRule, LiveSampler,
    QueueRunawayRule, ServiceLatencyRule, StallRule, StreamingBreakdown,
    StreamingLevel, StreamingThroughput, ThroughputDropRule, TraceCursor,
    Watcher, render_frame)
from repro_torch.observability.export import chrome_trace, export_chrome_trace
from repro_torch.core import spans
from repro_torch.core.spans import Span, SpanTrace
from repro_torch.observability.report import (REPORT_VERSION, RunReport,
                                              render_payload)

__all__ = [
    "PHASES", "PhaseStats", "GroupBreakdown", "LifecycleBreakdown",
    "lifecycle_breakdown",
    "METRICS", "Series", "timeseries", "throughput", "inflight", "occupancy",
    "backend_inflight", "sched_hold_depth", "service_queue_depth",
    "ALERT_EVENT", "TraceCursor", "StreamingThroughput", "StreamingLevel",
    "StreamingBreakdown", "Watcher", "LiveSampler", "render_frame",
    "Alert", "HealthRule", "HealthMonitor", "StallRule",
    "ThroughputDropRule", "QueueRunawayRule", "ServiceLatencyRule",
    "chrome_trace", "export_chrome_trace", "spans", "Span", "SpanTrace",
    "REPORT_VERSION", "RunReport", "render_payload",
]
