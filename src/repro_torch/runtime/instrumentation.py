"""Perf instrumentation: the counters the scenario sweep observes.

The perf-regression gate (:mod:`repro_torch.perf`) must measure what the runtime
*actually did* — descriptors accepted, coalescer output, ring occupancy,
drain batches — not re-derive those numbers from its own bookkeeping. A
:class:`PerfProbe` is a passive per-channel counter sink attached to a
:class:`repro_torch.runtime.DMARuntime` (``attach_probe``) and, optionally, a
:class:`repro_torch.serve.engine.ServeEngine`. Hook sites:

* ``DMARuntime.submit``   — post-coalesce descriptor counts, §II-C input
                            hit rate, wall-clock launch seconds;
* ``Channel.submit``      — ring occupancy high-water mark, ring-full
                            backpressure events;
* ``Channel.drain_one`` / ``DMARuntime._execute_fused``
                          — drained descriptor counts and drain seconds
                            (fused batches credited per channel);
* ``Channel.observe_speculation``
                          — speculation-policy depth updates (live depth,
                            update count, peak/floor — DESIGN.md §5);
* ``ServeEngine.step``    — active-slot occupancy, step seconds, and
                            admission stalls (queued requests, no slot);
* ``ServeEngine.poll_completed``
                          — completion events with §II-D writeback ->
                            poll latency in decode steps.

Probes never change behaviour: every hook is a no-op when no probe is
attached, and a probe failure is a bug, not a recoverable condition (no
exception guards — the probe is trusted first-party code).

Alongside the scalar dataclass counters (which feed the *deterministic*
``snapshot()`` gated in BENCH_perf.json), every probe owns a
:class:`repro_torch.obs.metrics.MetricsRegistry` of histograms/gauges fed from
the same hooks — wall-clock distributions (launch/drain/step µs), ring
occupancy, poll and request latencies. Those are exported separately via
``metrics_snapshot()`` and the JSONL dump, **never** mixed into
``snapshot()`` (wall-clock in the gated document would break bit-for-bit
reproducibility — DESIGN.md §4/§8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.obs.metrics import MetricsRegistry


@dataclasses.dataclass
class ChannelCounters:
    """What one channel did while a probe was attached."""

    submits: int = 0                 # DMARuntime.submit calls routed here
    submitted_descriptors: int = 0   # post-coalesce descriptors accepted
    coalesce_in: int = 0             # descriptors before the planner
    coalesce_out: int = 0            # descriptors after merge+split
    drained_descriptors: int = 0
    drain_batches: int = 0
    fused_batches: int = 0           # batches executed via the fused 2-D path
    drain_seconds: float = 0.0
    launch_seconds: float = 0.0      # wall-clock submit-side cost
    ring_full_events: int = 0
    occupancy_peak: int = 0          # ring high-water mark (slots in use)
    hit_rate_sum: float = 0.0        # §II-C input hit rate, summed
    hit_rate_n: int = 0
    # Speculation-policy trajectory (DESIGN.md §5): live depth after the
    # last observation, number of feedback updates, and the extremes the
    # policy visited while this probe was attached.
    speculation_depth: int = 0
    depth_updates: int = 0
    depth_peak: int = 0
    depth_floor: int = 0

    @property
    def merge_ratio(self) -> float:
        return self.coalesce_in / max(self.coalesce_out, 1)

    @property
    def mean_input_hit_rate(self) -> float:
        return self.hit_rate_sum / self.hit_rate_n if self.hit_rate_n else 1.0


@dataclasses.dataclass
class TranslationCounters:
    """Translation-cache events (chain-lowering JIT — DESIGN.md §7)."""

    hits: int = 0          # artifact LRU hits (compiled executor reused)
    misses: int = 0        # artifact LRU misses (new signature lowered)
    evictions: int = 0     # artifacts dropped past the LRU bound
    plan_hits: int = 0     # coalescer-plan memo hits (digest match)
    plan_misses: int = 0   # plans computed fresh
    transform_lookups: int = 0  # plans requested with a non-identity
                                # transform token (DESIGN.md §9)
    transform_fused: int = 0    # of those, served by a transform-fused
                                # compiled executor


@dataclasses.dataclass
class ServeCounters:
    """Serve-engine observations (one decode step = one event)."""

    steps: int = 0
    step_seconds: float = 0.0
    active_slot_steps: int = 0       # sum of busy slots over steps
    completions_observed: int = 0    # requests seen via §II-D writeback
    admission_stalls: int = 0        # steps with queued requests but no slot
    poll_latency_steps_sum: int = 0  # §II-D writeback -> poll observation


class PerfProbe:
    """Passive counter sink; one instance per measurement window."""

    def __init__(self) -> None:
        self.channels: Dict[str, ChannelCounters] = {}
        self.serve = ServeCounters()
        self.translation = TranslationCounters()
        self.metrics = MetricsRegistry()

    def reset(self) -> None:
        """Clear *all* counters — channels, serve, translation, metrics.

        Starts a fresh measurement window on the same probe object, so
        long-lived runtimes can reuse one attached probe across windows
        without re-plumbing ``attach_probe``.
        """
        self.channels.clear()
        self.serve = ServeCounters()
        self.translation = TranslationCounters()
        self.metrics.reset()

    def _ch(self, channel: str) -> ChannelCounters:
        c = self.channels.get(channel)
        if c is None:
            c = self.channels[channel] = ChannelCounters()
        return c

    # -- runtime-side hooks --------------------------------------------------
    def on_submit(self, channel: str, *, n_in: int, n_out: int,
                  launch_seconds: float,
                  hit_rate: Optional[float] = None) -> None:
        c = self._ch(channel)
        c.submits += 1
        c.submitted_descriptors += n_out
        c.coalesce_in += n_in
        c.coalesce_out += n_out
        c.launch_seconds += launch_seconds
        if hit_rate is not None:
            c.hit_rate_sum += hit_rate
            c.hit_rate_n += 1
        self.metrics.histogram("launch_us").record(launch_seconds * 1e6)

    def on_occupancy(self, channel: str, occupancy: int) -> None:
        c = self._ch(channel)
        if occupancy > c.occupancy_peak:
            c.occupancy_peak = occupancy
        self.metrics.gauge(f"ring_occupancy.{channel}").set(occupancy)

    def on_ring_full(self, channel: str) -> None:
        self._ch(channel).ring_full_events += 1

    def on_depth(self, channel: str, depth: int) -> None:
        """One speculation-policy feedback update (post-observation depth)."""
        c = self._ch(channel)
        c.speculation_depth = depth
        c.depth_peak = depth if c.depth_updates == 0 \
            else max(c.depth_peak, depth)
        c.depth_floor = depth if c.depth_updates == 0 \
            else min(c.depth_floor, depth)
        c.depth_updates += 1

    def on_drain(self, channel: str, *, n_descriptors: int, seconds: float,
                 fused: bool = False) -> None:
        c = self._ch(channel)
        c.drained_descriptors += n_descriptors
        c.drain_batches += 1
        c.fused_batches += int(fused)
        c.drain_seconds += seconds
        self.metrics.histogram("drain_us").record(seconds * 1e6)

    # -- translation-cache hooks ---------------------------------------------
    def on_translation(self, event: str) -> None:
        """One translation-cache event: hit/miss/evict/plan_hit/plan_miss."""
        t = self.translation
        if event == "hit":
            t.hits += 1
        elif event == "miss":
            t.misses += 1
        elif event == "evict":
            t.evictions += 1
        elif event == "plan_hit":
            t.plan_hits += 1
        elif event == "plan_miss":
            t.plan_misses += 1
        elif event == "transform_lookup":
            t.transform_lookups += 1
        elif event == "transform_fused":
            t.transform_fused += 1
        else:
            raise ValueError(f"unknown translation event {event!r}")

    # -- serve-side hooks ----------------------------------------------------
    def on_serve_step(self, active_slots: int, seconds: float) -> None:
        self.serve.steps += 1
        self.serve.active_slot_steps += active_slots
        self.serve.step_seconds += seconds
        self.metrics.histogram("serve_step_us").record(seconds * 1e6)
        self.metrics.gauge("serve_active_slots").set(active_slots)

    def on_serve_completion(self, n: int = 1,
                            latency_steps: Optional[int] = None) -> None:
        self.serve.completions_observed += n
        if latency_steps is not None:
            self.serve.poll_latency_steps_sum += latency_steps
            self.metrics.histogram("poll_latency_steps").record(latency_steps)

    def on_request_latency(self, steps: int) -> None:
        """End-to-end request latency (submit -> completion, decode steps)."""
        self.metrics.histogram("request_latency_steps").record(steps)

    def on_admission_stall(self) -> None:
        """One engine step that left requests queued behind full slots."""
        self.serve.admission_stalls += 1

    # -- export --------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """JSON-ready counter dump (ints/floats only).

        Deterministic-schema contract: the perf sweep stores parts of this
        verbatim in BENCH_perf.json, so new observability surface goes in
        ``metrics_snapshot()``, never here.
        """
        return {
            "channels": {name: dataclasses.asdict(c)
                         for name, c in sorted(self.channels.items())},
            "serve": dataclasses.asdict(self.serve),
            "translation": dataclasses.asdict(self.translation),
        }

    def metrics_snapshot(self) -> Dict[str, Dict[str, object]]:
        """Histogram/gauge registry dump (wall-clock-bearing; not gated)."""
        return self.metrics.snapshot()

    def perf_counters(self):
        """Flat unified-namespace view of :meth:`snapshot` (DESIGN.md §9).

        Canonical keys: ``channels.<name>.<field>``, ``serve.<field>``,
        ``translation.<field>``. The bare-key deprecated aliases were
        removed one release after 0.4. ``snapshot()`` keeps the nested
        legacy layout for stored BENCH documents.
        """
        from repro_torch.obs.counters import PerfCounters
        data: Dict[str, object] = {}
        for name, c in sorted(self.channels.items()):
            for k, v in dataclasses.asdict(c).items():
                data[f"channels.{name}.{k}"] = v
        for prefix, block in (
                ("serve", dataclasses.asdict(self.serve)),
                ("translation", dataclasses.asdict(self.translation))):
            for k, v in block.items():
                data[f"{prefix}.{k}"] = v
        return PerfCounters(data)
