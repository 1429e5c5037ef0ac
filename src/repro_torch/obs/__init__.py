"""Observability: lifecycle tracing, metrics and the unified counter view.

The port carries the three modules the runtime imports (``trace``,
``metrics``, ``counters``); the Perfetto export and the one-shot recorder
are not ported yet.
"""
from repro_torch.obs.counters import PerfCounters, namespaced
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import TraceEvent, Tracer, monotonic, monotonic_us

__all__ = [
    "Counter",
    "PerfCounters",
    "namespaced",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TraceEvent",
    "Tracer",
    "monotonic",
    "monotonic_us",
]
