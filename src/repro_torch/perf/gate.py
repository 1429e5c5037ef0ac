"""Perf-regression gate: compare the port's sweep against a committed baseline.

``python -m repro_torch.perf.gate --baseline BENCH_perf.json [--device cpu]``
re-runs the port's sweep with the exact spec recorded inside the baseline
document (mode, seed, repeats, dimensions — so the comparison is
seeded-median vs seeded-median) and fails with a nonzero exit when any
gated metric regresses past its tolerance band. Every failure names the
cell (arch/workload/channels/L) and the metric, so a red run points at
*what* eroded, not just *that* something did.

The baseline is the reference's document: the gate reads it and never
writes it. Every cell kind of it is ported (``dma``, ``mmu``,
``transform``, ``serve`` and ``sharded``), so the comparison is whole.

Comparison semantics (DESIGN.md §4):

* metrics have a polarity — ``bus_utilization``, ``coalesce_merge_ratio``
  and ``speculation_hit_rate`` regress *downward*,
  ``launch_cycles_per_transfer`` regresses *upward*;
* a cell fails when the relative change in the bad direction exceeds the
  metric's tolerance band (improvements never fail, however large);
* a baseline cell or metric missing from the current run is an *error*
  (exit 2), not a pass — silence must never look green;
* schema-version or spec mismatches between the documents are errors too.

Exit codes: 0 pass, 1 regression, 2 malformed/incomparable documents.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from .mmu_cell import MMU_GATED_METRICS
from .serve_cell import SERVE_GATED_METRICS
from .sharded_cell import SHARDED_GATED_METRICS
from .transform_cell import TRANSFORM_GATED_METRICS
from .sweep import (
    COMMITTED_BASELINE,
    GATED_METRICS,
    SCHEMA_VERSION,
    run_sweep,
    spec_from_doc,
    write_doc,
)

#: Cell kinds whose modules are not ported yet: none.
NOT_PORTED_KINDS = ()


class GateError(Exception):
    """The documents cannot be compared (schema, spec, or coverage)."""


#: Relative tolerance bands per gated metric (fraction of baseline value).
DEFAULT_TOLERANCES: Dict[str, float] = {
    "bus_utilization": 0.03,
    "launch_cycles_per_transfer": 0.05,
    "coalesce_merge_ratio": 0.03,
    "speculation_hit_rate": 0.03,
    "spec_bus_utilization_fixed4": 0.03,
    "spec_bus_utilization_adaptive": 0.03,
    # Serve-path scheduling metrics are small-integer ratios: identical on
    # an unchanged tree, so the band only absorbs intentional re-scoping.
    "admission_stall_rate": 0.10,
    "completion_poll_latency_steps": 0.10,
    "serve_steps_per_request": 0.05,
    # Sharded mesh cells (DESIGN.md §6). Migration cycles sit on a
    # saturating interconnect, so queueing amplifies small plan changes —
    # the wider band absorbs that without letting real fabric regressions
    # (an extra hop per plan, a lost merge) through.
    "cross_shard_migration_cycles": 0.05,
    "per_shard_bus_utilization": 0.03,
    "migration_chain_merge_ratio": 0.03,
    # Async-fabric sharded metrics (schema v7, DESIGN.md §10). Overlap and
    # resize retention are logical-round ratios from the deterministic
    # fabric clock (exact on an unchanged tree); the stall p99 rides the
    # contended per-link interconnect model, so it gets the same queueing
    # band as the migration-cycle mean. Convergence steps are a small
    # integer, so the band only absorbs intentional planner re-tuning.
    "migration_overlap_ratio": 0.03,
    "p99_migration_stall_cycles": 0.05,
    "rebalance_convergence_steps": 0.10,
    "throughput_retained_during_resize": 0.03,
    # Chain-lowering translation cache (DESIGN.md §7). Steady-state hit
    # rate is a counter-delta ratio (deterministic on an unchanged tree);
    # launch speedup comes from the cycle model, also deterministic.
    "translation_cache_hit_rate": 0.03,
    "translation_launch_speedup": 0.05,
    # Serve tail latency (schema v5, DESIGN.md §8): medians move only when
    # scheduling changes; the p99 band is wider because a single request's
    # latency shift can move the tail of a small seeded cell.
    "request_latency_steps_p50": 0.05,
    "request_latency_steps_p99": 0.10,
    # Per-percentile bands of the histogram-valued metric; overridable as
    # --tolerance request_latency_steps.p95=0.2 etc.
    "request_latency_steps.p50": 0.05,
    "request_latency_steps.p95": 0.10,
    "request_latency_steps.p99": 0.10,
    # In-flight transform cells (schema v6, DESIGN.md §9). Bandwidths come
    # from the deterministic cycle model; fidelity is a seeded roundtrip
    # through the numpy oracle, so all of these are exact on an unchanged
    # tree and the bands only absorb intentional re-scoping.
    "effective_bandwidth_fp32": 0.03,
    "effective_bandwidth_int8": 0.03,
    "effective_bandwidth_gain": 0.03,
    "fidelity_max_rel_err": 0.10,
    "transform_fusion_hit_rate": 0.03,
    # MMU/IOTLB cells (schema v8, DESIGN.md §11). Every number comes from
    # the deterministic cycle model or the page-table cost model (exact
    # on an unchanged tree); the bands only absorb intentional re-tuning
    # of the walk/prefetch parameters.
    "tlb_hit_rate": 0.03,
    "walk_stall_cycles": 0.05,
    "defrag_remap_cycles": 0.05,
    "defrag_copy_cycles": 0.05,
    # Ownership-first migration (sharded cells, schema v8): first-touch
    # rounds ride the deterministic fabric clock; small integers, so the
    # band only absorbs intentional pull-path re-scoping.
    "first_touch_latency_rounds": 0.10,
}

#: Histogram-valued gated metrics (schema v5): the cell stores the full
#: snapshot dict; the gate compares it at these named percentiles, each
#: with its own tolerance band (keyed ``metric.percentile`` above).
HISTOGRAM_METRICS: Dict[str, Sequence[str]] = {
    "request_latency_steps": ("p50", "p95", "p99"),
}

#: +1 -> higher is better (regression = drop); -1 -> lower is better.
METRIC_POLARITY: Dict[str, int] = {
    "bus_utilization": +1,
    "launch_cycles_per_transfer": -1,
    "coalesce_merge_ratio": +1,
    "speculation_hit_rate": +1,
    "spec_bus_utilization_fixed4": +1,
    "spec_bus_utilization_adaptive": +1,
    "admission_stall_rate": -1,
    "completion_poll_latency_steps": -1,
    "serve_steps_per_request": -1,
    "cross_shard_migration_cycles": -1,
    "per_shard_bus_utilization": +1,
    "migration_chain_merge_ratio": +1,
    "migration_overlap_ratio": +1,
    "p99_migration_stall_cycles": -1,
    "rebalance_convergence_steps": -1,
    "throughput_retained_during_resize": +1,
    "translation_cache_hit_rate": +1,
    "translation_launch_speedup": +1,
    "request_latency_steps_p50": -1,
    "request_latency_steps_p99": -1,
    "request_latency_steps": -1,   # applied at each gated percentile
    "effective_bandwidth_fp32": +1,
    "effective_bandwidth_int8": +1,
    "effective_bandwidth_gain": +1,
    "fidelity_max_rel_err": -1,
    "transform_fusion_hit_rate": +1,
    "tlb_hit_rate": +1,
    "walk_stall_cycles": -1,
    "defrag_remap_cycles": -1,
    "defrag_copy_cycles": -1,
    "first_touch_latency_rounds": -1,
}

ALL_GATED_METRICS = (tuple(GATED_METRICS) + tuple(SERVE_GATED_METRICS)
                     + tuple(SHARDED_GATED_METRICS)
                     + tuple(TRANSFORM_GATED_METRICS)
                     + tuple(MMU_GATED_METRICS))

_KIND_METRICS = {
    "serve": SERVE_GATED_METRICS,
    "sharded": SHARDED_GATED_METRICS,
    "transform": TRANSFORM_GATED_METRICS,
    "mmu": MMU_GATED_METRICS,
}


def metrics_for_cell(cell: Dict[str, object]) -> Sequence[str]:
    """The gated metric set a cell must carry, by cell kind."""
    return _KIND_METRICS.get(cell.get("kind"), GATED_METRICS)


@dataclasses.dataclass(frozen=True)
class Regression:
    cell: str
    metric: str
    baseline: float
    current: float
    rel_change: float       # signed, in the metric's natural direction
    tolerance: float

    @property
    def message(self) -> str:
        return (f"REGRESSION cell={self.cell} metric={self.metric} "
                f"baseline={self.baseline:.6g} current={self.current:.6g} "
                f"({self.rel_change:+.2%} exceeds "
                f"{self.tolerance:.0%} tolerance)")


def load_doc(path: str) -> Dict[str, object]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        raise GateError(f"baseline document not found: {path}")
    except json.JSONDecodeError as e:
        raise GateError(f"{path} is not valid JSON: {e}")
    check_schema(doc, path)
    return doc


_REQUIRED_DIMS = ("archs", "workloads", "channel_counts", "mem_latencies")


def check_schema(doc: Dict[str, object], label: str = "document") -> None:
    version = doc.get("schema_version")
    if version != SCHEMA_VERSION:
        raise GateError(
            f"{label}: schema_version {version!r} does not match this "
            f"tool's schema {SCHEMA_VERSION}; the baseline is regenerated "
            "by the reference's sweep (see DESIGN.md §4 re-baselining)")
    if not isinstance(doc.get("cells"), dict) or not doc["cells"]:
        raise GateError(f"{label}: no cells — not a sweep document")
    for key in ("mode", "seed", "repeats"):
        if key not in doc:
            raise GateError(
                f"{label}: missing {key!r} — malformed sweep document; "
                "regenerate it")
    dims = doc.get("dimensions")
    if not isinstance(dims, dict) or any(d not in dims
                                         for d in _REQUIRED_DIMS):
        raise GateError(
            f"{label}: missing or incomplete 'dimensions' (need "
            f"{_REQUIRED_DIMS}) — malformed sweep document; regenerate it")


def compare(
    baseline: Dict[str, object],
    current: Dict[str, object],
    tolerances: Optional[Dict[str, float]] = None,
) -> List[Regression]:
    """All tolerance-band violations of ``current`` vs ``baseline``.

    Raises :class:`GateError` when the documents are incomparable: schema
    mismatch, a baseline cell absent from the current run, or a gated
    metric absent from a present cell.
    """
    check_schema(baseline, "baseline")
    check_schema(current, "current")
    tol = dict(DEFAULT_TOLERANCES)
    if tolerances:
        tol.update(tolerances)

    regressions: List[Regression] = []
    cur_cells = current["cells"]
    for key, cell in sorted(baseline["cells"].items()):
        cur = cur_cells.get(key)
        if cur is None:
            raise GateError(
                f"cell {key} present in baseline but missing from current "
                "run — sweep coverage shrank (did the registry or workload "
                "set change without re-baselining?)")
        base_metrics = cell.get("metrics")
        if not isinstance(base_metrics, dict):
            raise GateError(
                f"cell {key}: baseline cell has no metrics dict — the "
                "baseline document is malformed; regenerate it")
        cur_metrics = cur.get("metrics", {})
        for metric in metrics_for_cell(cell):
            if metric not in base_metrics:
                raise GateError(
                    f"cell {key}: gated metric {metric!r} missing from "
                    "baseline — the baseline predates this metric; "
                    "re-baseline (DESIGN.md §4)")
            if metric not in cur_metrics:
                raise GateError(
                    f"cell {key}: gated metric {metric!r} missing from "
                    "current run — the sweep stopped measuring it")
            polarity = METRIC_POLARITY[metric]
            if metric in HISTOGRAM_METRICS:
                # Histogram-valued metric (schema v5): compare the stored
                # snapshot at each named percentile, each under its own
                # tolerance band. Absolute floor of one bucket absorbs
                # integer-step jitter around tiny baselines (a 2-step p50
                # moving to 3 is not a 50% regression worth failing on).
                base_snap, cur_snap = base_metrics[metric], cur_metrics[metric]
                if not isinstance(base_snap, dict) \
                        or not isinstance(cur_snap, dict):
                    raise GateError(
                        f"cell {key}: metric {metric!r} should be a "
                        "histogram snapshot dict in both documents; "
                        "re-baseline (DESIGN.md §8)")
                for pct in HISTOGRAM_METRICS[metric]:
                    if pct not in base_snap or pct not in cur_snap:
                        raise GateError(
                            f"cell {key}: histogram metric {metric!r} "
                            f"lacks percentile {pct!r}; re-baseline")
                    base_v = float(base_snap[pct])
                    cur_v = float(cur_snap[pct])
                    denom = max(abs(base_v), 1e-12)
                    rel = (cur_v - base_v) / denom
                    band = tol.get(f"{metric}.{pct}", 0.10)
                    if polarity * rel < -band and abs(cur_v - base_v) > 1.0:
                        regressions.append(Regression(
                            cell=key, metric=f"{metric}.{pct}",
                            baseline=base_v, current=cur_v,
                            rel_change=rel, tolerance=band))
                continue
            base_v = float(base_metrics[metric])
            cur_v = float(cur_metrics[metric])
            denom = max(abs(base_v), 1e-12)
            rel = (cur_v - base_v) / denom
            band = tol.get(metric, 0.05)
            if polarity * rel < -band:
                regressions.append(Regression(
                    cell=key, metric=metric, baseline=base_v,
                    current=cur_v, rel_change=rel, tolerance=band))
    return regressions


#: The dimensions a quick (CI) sweep covers; --quick gates this subset.
_QUICK_CHANNELS = (4,)
_QUICK_LATENCIES = (13, 100)


def quick_subset(doc: Dict[str, object]):
    """Restrict a baseline to the quick sweep dimensions (ch4, L13/L100).

    Lets CI gate a reduced sweep against a *full-mode* baseline: the
    returned document keeps the baseline's mode/scale (so re-run cells
    stay comparable) but drops cells outside the quick channel/latency
    axes. Returns ``(subset_doc, n_dropped)``; raises GateError when
    nothing remains (the baseline never covered the quick dimensions).
    """
    dims = doc["dimensions"]
    ch = [c for c in dims["channel_counts"] if c in _QUICK_CHANNELS]
    lat = [m for m in dims["mem_latencies"] if m in _QUICK_LATENCIES]
    # Serve and sharded cells are already reduced-config; the quick sweep
    # always runs them, so they always stay gated. Transform cells keep
    # only the quick (size, latency) grid a reduced sweep regenerates.
    from .transform_cell import DEFAULT_TRANSFORM_SPEC
    cells = {k: c for k, c in doc["cells"].items()
             if (c.get("kind") == "transform"
                 and c.get("mem_latency") in DEFAULT_TRANSFORM_SPEC
                 .mem_latencies
                 and c.get("transfer_bytes") in DEFAULT_TRANSFORM_SPEC
                 .transfer_bytes)
             or c.get("kind") in ("serve", "sharded")
             or (c.get("kind") == "mmu" and c.get("mem_latency") in lat)
             or (c.get("kind") == "dma" and c.get("channels") in ch
                 and c.get("mem_latency") in lat)}
    if not cells:
        raise GateError(
            "--quick: baseline has no cells in the quick dimensions "
            f"(channels {_QUICK_CHANNELS}, latencies {_QUICK_LATENCIES}); "
            "run without --quick or re-baseline")
    out = dict(doc)
    out["dimensions"] = dict(dims, channel_counts=ch, mem_latencies=lat)
    out["cells"] = cells
    return out, len(doc["cells"]) - len(cells)


def ported_subset(doc: Dict[str, object]):
    """Restrict a baseline to the cells this package can regenerate.

    Drops the cells of :data:`NOT_PORTED_KINDS` — none, now that the
    ``sharded`` cells are ported — so the subset is the whole baseline.
    Returns ``(subset_doc, dropped_keys)``; raises GateError when nothing
    remains. Every baseline cell the current run lacks stays an error in
    :func:`compare`.
    """
    dropped = sorted(k for k, c in doc["cells"].items()
                     if c.get("kind") in NOT_PORTED_KINDS)
    cells = {k: c for k, c in doc["cells"].items() if k not in dropped}
    if not cells:
        raise GateError("baseline has no cells this package can regenerate")
    out = dict(doc)
    out["cells"] = cells
    return out, dropped


def speculation_summary(doc: Dict[str, object]) -> str:
    """Adaptive-vs-fixed utilization delta, per workload and overall.

    Printed with every gate verdict (and into the CI job summary): the
    live evidence for the §II-C adaptive-policy claim — adaptive matches
    fixed-depth-4 on sequential streams and beats it on MoE dispatch
    storms (DESIGN.md §5).
    """
    per_workload: Dict[str, List[float]] = {}
    for cell in doc["cells"].values():
        m = cell.get("metrics", {})
        fixed = m.get("spec_bus_utilization_fixed4")
        adaptive = m.get("spec_bus_utilization_adaptive")
        if fixed is None or adaptive is None:
            continue
        delta = (adaptive - fixed) / max(abs(fixed), 1e-12)
        per_workload.setdefault(cell.get("workload", "?"), []).append(delta)
    if not per_workload:
        return "speculation: no adaptive-vs-fixed cells in this document"
    lines = ["speculation: adaptive vs fixed-depth-4 bus utilization"]
    all_deltas: List[float] = []
    for wl in sorted(per_workload):
        ds = per_workload[wl]
        all_deltas.extend(ds)
        lines.append(f"  {wl:<14} mean {sum(ds) / len(ds):+8.1%}  "
                     f"min {min(ds):+8.1%}  ({len(ds)} cells)")
    lines.append(f"  {'overall':<14} mean "
                 f"{sum(all_deltas) / len(all_deltas):+8.1%}")
    return "\n".join(lines)


def sharded_summary(doc: Dict[str, object]) -> str:
    """Per-mesh-size migration table (printed with every gate verdict and
    into the CI job summary, next to the adaptive-vs-fixed delta)."""
    rows = sorted(
        ((int(c.get("mesh", 0)), c.get("metrics", {}))
         for c in doc["cells"].values() if c.get("kind") == "sharded"),
        key=lambda r: r[0])
    if not rows:
        return "sharded: no mesh cells in this document"
    lines = ["sharded: cross-shard migration by mesh size",
             f"  {'mesh':>4}  {'migration_cycles':>16}  "
             f"{'per_shard_util':>14}  {'merge_ratio':>11}  "
             f"{'overlap':>7}  {'stall_p99':>9}  {'rebal':>5}  "
             f"{'retained':>8}  {'1st_touch':>9}"]
    for mesh, m in rows:
        lines.append(
            f"  {mesh:>4}  "
            f"{m.get('cross_shard_migration_cycles', float('nan')):>16.1f}  "
            f"{m.get('per_shard_bus_utilization', float('nan')):>14.3f}  "
            f"{m.get('migration_chain_merge_ratio', float('nan')):>11.2f}  "
            f"{m.get('migration_overlap_ratio', float('nan')):>7.2f}  "
            f"{m.get('p99_migration_stall_cycles', float('nan')):>9.1f}  "
            f"{m.get('rebalance_convergence_steps', float('nan')):>5.0f}  "
            f"{m.get('throughput_retained_during_resize', float('nan')):>8.2f}  "
            f"{m.get('first_touch_latency_rounds', float('nan')):>9.0f}")
    return "\n".join(lines)


def mmu_summary(doc: Dict[str, object]) -> str:
    """IOTLB + remap-vs-copy defrag table (schema v8, DESIGN.md §11).

    The live evidence for the MMU-aware paging claims: chain-lookahead
    translation prefetch keeps the sequential paged-KV stream >= 0.9
    IOTLB hit rate, and remap-defrag undercuts copy-defrag at every
    memory latency."""
    if not doc.get("iotlb_enabled", True):
        return "mmu: IOTLB cells disabled in this document (--no-iotlb)"
    rows = sorted(
        ((int(c.get("mem_latency", 0)), c.get("metrics", {}),
          c.get("counters", {}))
         for c in doc["cells"].values() if c.get("kind") == "mmu"))
    if not rows:
        return "mmu: no MMU cells in this document"
    lines = ["mmu: IOTLB hit rate and remap-vs-copy defrag by latency",
             f"  {'L':>3}  {'tlb_hit':>7}  {'walk_stall':>10}  "
             f"{'remap_cyc':>9}  {'copy_cyc':>8}  {'speedup':>7}"]
    for lat, m, c in rows:
        remap = m.get("defrag_remap_cycles", float("nan"))
        copy = m.get("defrag_copy_cycles", float("nan"))
        lines.append(
            f"  {lat:>3}  "
            f"{m.get('tlb_hit_rate', float('nan')):>7.3f}  "
            f"{m.get('walk_stall_cycles', float('nan')):>10.0f}  "
            f"{remap:>9.0f}  {copy:>8.0f}  "
            f"{copy / max(remap, 1.0):>6.1f}x")
    return "\n".join(lines)


def translation_summary(doc: Dict[str, object]) -> str:
    """Per-workload translation-cache table (DESIGN.md §7).

    Steady-state cache hit rate and cycle-model launch speedup, the live
    evidence for the chain-lowering claim: structurally-identical serve
    chains re-dispatch cached artifacts (hit rate -> 1.0) and the cached
    frontend beats the §II-A serialized baseline by ≥1.66x at
    64-byte-class units.
    """
    if not doc.get("translation_cache_enabled", True):
        return "translation: cache disabled in this document " \
               "(--no-translation-cache)"
    per_workload: Dict[str, List[tuple]] = {}
    for cell in doc["cells"].values():
        m = cell.get("metrics", {})
        hit = m.get("translation_cache_hit_rate")
        speedup = m.get("translation_launch_speedup")
        if hit is None or speedup is None:
            continue
        per_workload.setdefault(cell.get("workload", "?"), []).append(
            (hit, speedup))
    if not per_workload:
        return "translation: no translation-cache cells in this document"
    lines = ["translation: chain-lowering cache by workload",
             f"  {'workload':<14} {'hit_rate':>8}  {'min_hit':>7}  "
             f"{'speedup':>7}  {'max_speedup':>11}"]
    for wl in sorted(per_workload):
        rows = per_workload[wl]
        hits = [r[0] for r in rows]
        sps = [r[1] for r in rows]
        lines.append(f"  {wl:<14} {sum(hits) / len(hits):>8.3f}  "
                     f"{min(hits):>7.3f}  {sum(sps) / len(sps):>6.2f}x  "
                     f"{max(sps):>10.2f}x  ({len(rows)} cells)")
    return "\n".join(lines)


def transform_summary(doc: Dict[str, object]) -> str:
    """Per-size int8-vs-fp32 effective-bandwidth table (DESIGN.md §9).

    The live evidence for the in-flight transform claim: a quantized KV
    transfer moves fewer bus beats at equal logical payload (gain > 1)
    without trading away roundtrip fidelity, and every transform plan is
    served by a transform-fused compiled executor.
    """
    rows = sorted(
        ((int(c.get("transfer_bytes", 0)), int(c.get("mem_latency", 0)),
          c.get("metrics", {}))
         for c in doc["cells"].values() if c.get("kind") == "transform"))
    if not rows:
        return "transform: no transform cells in this document"
    lines = ["transform: EF-int8 KV quantize vs fp32 effective bandwidth",
             f"  {'bytes':>6}  {'L':>3}  {'bw_fp32':>8}  {'bw_int8':>8}  "
             f"{'gain':>6}  {'fidelity':>8}  {'fusion':>6}"]
    for nbytes, lat, m in rows:
        lines.append(
            f"  {nbytes:>6}  {lat:>3}  "
            f"{m.get('effective_bandwidth_fp32', float('nan')):>8.3f}  "
            f"{m.get('effective_bandwidth_int8', float('nan')):>8.3f}  "
            f"{m.get('effective_bandwidth_gain', float('nan')):>5.2f}x  "
            f"{m.get('fidelity_max_rel_err', float('nan')):>8.5f}  "
            f"{m.get('transform_fusion_hit_rate', float('nan')):>6.2f}")
    return "\n".join(lines)


def serve_latency_summary(doc: Dict[str, object]) -> str:
    """p50/p99 request-latency table over the serve cells (DESIGN.md §8).

    The tail-latency evidence the ROADMAP's continuous-batching work
    gates on — printed with every verdict and into the CI job summary.
    """
    rows = []
    for key, cell in sorted(doc["cells"].items()):
        if cell.get("kind") != "serve":
            continue
        m = cell.get("metrics", {})
        snap = m.get("request_latency_steps")
        if not isinstance(snap, dict):
            continue
        rows.append((key, m.get("request_latency_steps_p50", float("nan")),
                     snap.get("p95", float("nan")),
                     m.get("request_latency_steps_p99", float("nan")),
                     float(snap.get("sum", 0)) / max(int(snap.get("n", 0)), 1),
                     int(snap.get("n", 0))))
    if not rows:
        return "serve latency: no serve-cell histograms in this document"
    lines = ["serve latency: request p50/p99 (decode steps, exact buckets)",
             f"  {'cell':<28} {'p50':>6}  {'p95':>6}  {'p99':>6}  "
             f"{'mean':>7}  {'n':>4}"]
    for key, p50, p95, p99, mean, n in rows:
        lines.append(f"  {key:<28} {p50:>6.1f}  {p95:>6.1f}  {p99:>6.1f}  "
                     f"{mean:>7.2f}  {n:>4d}")
    return "\n".join(lines)


def _emit_summary(doc: Dict[str, object]) -> None:
    for summary in (speculation_summary, sharded_summary,
                    translation_summary, transform_summary,
                    serve_latency_summary, mmu_summary):
        print(summary(doc))


def _parse_tolerances(pairs: Sequence[str]) -> Dict[str, float]:
    hist_keys = tuple(f"{m}.{p}" for m, pcts in HISTOGRAM_METRICS.items()
                      for p in pcts)
    out: Dict[str, float] = {}
    for p in pairs:
        if "=" not in p:
            raise GateError(
                f"--tolerance expects metric=fraction, got {p!r}")
        k, v = p.split("=", 1)
        if k not in ALL_GATED_METRICS and k not in hist_keys:
            raise GateError(
                f"--tolerance: unknown metric {k!r}; "
                f"have {ALL_GATED_METRICS + hist_keys}")
        try:
            out[k] = float(v)
        except ValueError:
            raise GateError(f"--tolerance: {v!r} is not a number")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.perf.gate",
        description="Compare the port's perf sweep against a committed "
                    "baseline; exit 1 on regression, 2 on an error.")
    ap.add_argument("--baseline", required=True,
                    help="committed BENCH_perf.json to compare against "
                         "(read only)")
    ap.add_argument("--current",
                    help="precomputed sweep document; omitted -> re-run the "
                         "port's sweep with the baseline's recorded spec")
    ap.add_argument("--device", default=None,
                    help="device of the re-run's runtime passes: cuda "
                         "(default) or cpu")
    ap.add_argument("--quick", action="store_true",
                    help="gate only the quick-dimension subset of the "
                         "baseline (ch=4, L in {13,100}); errors if the "
                         "baseline never covered those dimensions")
    ap.add_argument("--out",
                    help="also write the current sweep document here")
    ap.add_argument("--tolerance", action="append", default=[],
                    metavar="METRIC=FRACTION",
                    help="override a tolerance band, repeatable")
    args = ap.parse_args(argv)

    try:
        baseline = load_doc(args.baseline)
        tolerances = _parse_tolerances(args.tolerance)
        if args.quick:
            baseline, dropped = quick_subset(baseline)
            if dropped:
                print(f"--quick: gating {len(baseline['cells'])} of "
                      f"{len(baseline['cells']) + dropped} baseline cells "
                      "(quick dimensions; the rest need a full run)")
        baseline, _ = ported_subset(baseline)
        if args.current:
            current = load_doc(args.current)
        else:
            spec = spec_from_doc(baseline)
            print(f"re-running sweep: mode={spec.mode} seed={spec.seed} "
                  f"repeats={spec.repeats} "
                  f"({len(baseline['cells'])} baseline cells)")
            current = run_sweep(spec, device=args.device)
        if args.out:
            if os.path.realpath(args.out) == \
                    os.path.realpath(COMMITTED_BASELINE):
                raise GateError("--out names the committed baseline, which "
                                "this gate never writes")
            write_doc(current, args.out)
            print(f"wrote current sweep to {args.out}")
        regressions = compare(baseline, current, tolerances)
    except GateError as e:
        print(f"GATE ERROR: {e}", file=sys.stderr)
        return 2

    _emit_summary(current)
    n = len(baseline["cells"])
    if regressions:
        for r in regressions:
            print(r.message, file=sys.stderr)
        print(f"perf gate: FAIL — {len(regressions)} regression(s) "
              f"across {n} cells", file=sys.stderr)
        return 1
    print(f"perf gate: PASS — {n} cells within tolerance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
