"""Observability: lifecycle tracing, metrics and the unified counter view.

``trace``, ``metrics`` and ``counters`` are what the runtime imports;
``export`` writes Chrome/Perfetto ``trace_event`` JSON and flat JSONL
metrics, and ``record`` is the one-shot seeded serve trace recorder.
"""
from repro_torch.obs.counters import PerfCounters, namespaced
from repro_torch.obs.export import (
    chrome_trace,
    write_chrome_trace,
    write_metrics_jsonl,
)
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
    "chrome_trace",
    "monotonic",
    "monotonic_us",
    "write_chrome_trace",
    "write_metrics_jsonl",
]
