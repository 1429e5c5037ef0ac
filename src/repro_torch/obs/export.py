"""Chrome/Perfetto ``trace_event`` JSON export + flat JSONL metrics dump.

The exported document is the JSON-object form of the trace_event format
(loadable at https://ui.perfetto.dev and chrome://tracing): one *process*
per tracer track (channel, shard-qualified channel, serve loop, fabric,
simulator config), named via "M"/``process_name`` metadata events.

Timestamps are normalized per clock domain: all wall events shift so the
earliest wall event is t=0, and all cycle events likewise (1 simulated
cycle is rendered as 1 µs on its own tracks) — the two domains share a
viewport without pretending to share a clock.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import TraceEvent


def _track_pids(events: Iterable[TraceEvent]) -> Dict[str, int]:
    """Assign pids to tracks in first-appearance order (stable export)."""
    pids: Dict[str, int] = {}
    for ev in events:
        if ev.track not in pids:
            pids[ev.track] = len(pids) + 1
    return pids


def chrome_trace(events: List[TraceEvent]) -> Dict[str, object]:
    """Render tracer events as a trace_event JSON document (dict)."""
    pids = _track_pids(events)
    mins: Dict[str, float] = {}
    for ev in events:
        cur = mins.get(ev.clock)
        if cur is None or ev.ts < cur:
            mins[ev.clock] = ev.ts

    out: List[Dict[str, object]] = []
    for track, pid in pids.items():
        out.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": track}})
    for ev in events:
        rec: Dict[str, object] = {
            "name": ev.name,
            "cat": ev.clock,
            "ph": ev.ph,
            "ts": ev.ts - mins[ev.clock],
            "pid": pids[ev.track],
            "tid": 0,
        }
        if ev.ph == "X":
            rec["dur"] = ev.dur if ev.dur is not None else 0.0
        if ev.ph == "i":
            rec["s"] = "t"                      # thread-scoped instant
        if ev.ph in ("b", "e", "s", "t", "f"):
            rec["id"] = ev.id
            rec["cat"] = "flow" if ev.ph in ("s", "t", "f") else ev.clock
        if ev.ph in ("s", "t", "f"):
            rec["bp"] = "e"                     # bind to enclosing slice
        if ev.args:
            rec["args"] = dict(ev.args)
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, events: List[TraceEvent]) -> Dict[str, object]:
    doc = chrome_trace(events)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return doc


def write_metrics_jsonl(path: str,
                        registry: Optional[MetricsRegistry] = None,
                        *,
                        extra: Optional[Dict[str, Dict[str, object]]] = None,
                        ) -> int:
    """Flat metrics dump: one JSON object per line, name-sorted.

    ``extra`` merges additional pre-snapshotted metric dicts (e.g. per-shard
    registries already folded, or probe scalar counters wrapped as
    ``{"type": "counter", "value": ...}``).
    """
    merged: Dict[str, Dict[str, object]] = {}
    if registry is not None:
        merged.update(registry.snapshot())
    if extra:
        merged.update(extra)
    n = 0
    with open(path, "w") as fh:
        for name in sorted(merged):
            fh.write(json.dumps({"name": name, **merged[name]},
                                sort_keys=True) + "\n")
            n += 1
    return n
