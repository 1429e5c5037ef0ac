"""Scenario sweep: every (config x workload x channels x mem-latency) cell.

Each ``dma`` cell runs in both substrates:

1. **Runtime pass** — the cell's workload chains are submitted to a real
   :class:`repro_torch.runtime.DMARuntime` with ``channels`` serial-tier
   virtual channels over float32 pools on the sweep's device, and drained
   to idle. A :class:`repro_torch.runtime.PerfProbe` is attached, so the
   coalescer merge ratio, the §II-C speculation hit rate and the
   per-channel counters come from the runtime's own instrumentation. On
   CUDA pools the lowered drains of uniform aligned units go through the
   ``descriptor_copy`` kernel (``runtime/lowering.py``).
2. **Cycle-model pass** — :func:`repro_torch.core.simulator.
   simulate_multichannel` reproduces the cell's bus behaviour (N
   frontends, fair arbiter, the cell's memory latency) at the workload's
   representative transfer size: steady-state bus utilization and launch
   cycles per transfer.
3. **Speculation-policy pass** — the single-frontend cycle model runs the
   cell's traffic (its measured §II-C hit rate) under a ``FixedDepth(4)``
   and an ``AdaptiveDepth`` frontend and reports the contention-discounted
   utilizations ``spec_bus_utilization_fixed4`` / ``_adaptive``.
4. **Translation pass** — the runtime pass replays each workload's chains
   over warm rounds for the steady-state chain-lowering cache hit rate,
   and the cycle model compares the §II-A next-field-serialized frontend
   with a cached-artifact frontend (``translation_launch_speedup``).

The ``mmu`` cells (cycle model with the IOTLB) and the ``transform`` cells
(cycle model, the numpy kv8 oracle and a kv_int8 runtime on the sweep's
device) come from :mod:`.mmu_cell` and :mod:`.transform_cell`; the
``serve`` cell (a reduced-config :class:`repro_torch.serve.ServeEngine`
on the sweep's device) from :mod:`.serve_cell`; the ``sharded`` mesh cells
(:class:`repro_torch.distributed.ShardedDMARuntime` over logical shards on
the sweep's device, and the sharded cycle model) from :mod:`.sharded_cell`.

The document is *bit-for-bit reproducible* from ``(mode, seed)``: gated
metrics are medians over ``repeats`` seeded re-generations, wall-clock
numbers never enter it, and stored counters are the deterministic subset
of the probe snapshot. It is the schema of the committed
``BENCH_perf.json``, so the port's cells compare with it key for key.

CLI: ``python -m repro_torch.perf.sweep [--out build/BENCH_perf.port.json]
[--full] [--seed N] [--device cpu|cuda]``
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core.simulator import (
    SimConfig,
    simulate,
    simulate_multichannel,
)
from repro_torch.core.speculation import DEFAULT_DEPTH, FixedDepth
from repro_torch.runtime import (
    ChannelConfig,
    DMARuntime,
    PerfProbe,
    SubmitRequest,
)

from .mmu_cell import DEFAULT_MMU_SPEC, MMU_GATED_METRICS, mmu_cell_entries
from .serve_cell import DEFAULT_SERVE_SPEC, SERVE_GATED_METRICS, run_serve_cell
from .sharded_cell import (
    DEFAULT_SHARDED_SPEC,
    MESH_SIZES,
    SHARDED_GATED_METRICS,
    cell_entry as sharded_cell_entry,
)
from .transform_cell import (
    DEFAULT_TRANSFORM_SPEC,
    TRANSFORM_GATED_METRICS,
    transform_cell_entries,
)
from .workloads import SCALES, WORKLOAD_NAMES, Scale, generate

#: The document schema of the committed ``BENCH_perf.json`` (v8: the mmu
#: cells and ``iotlb_enabled``; see the schema history in DESIGN.md §4).
SCHEMA_VERSION = 8

#: The gated perf surface of DMA cells. gate.py refuses documents missing
#: any of these.
GATED_METRICS = (
    "bus_utilization",
    "launch_cycles_per_transfer",
    "coalesce_merge_ratio",
    "speculation_hit_rate",
    "spec_bus_utilization_fixed4",
    "spec_bus_utilization_adaptive",
    "translation_cache_hit_rate",
    "translation_launch_speedup",
)

#: Warm replay rounds of the runtime pass: the workload's chains are
#: resubmitted unchanged after the cold round, and the steady-state
#: translation-cache hit rate is the artifact-cache hit fraction over the
#: warm rounds alone (counter deltas, so cold-round compiles never dilute
#: it). Ratio metrics (merge ratio, §II-C hit rate) are invariant under
#: the replays — identical chains scale numerator and denominator alike.
_WARM_ROUNDS = 3

#: Frontends of the speculation-policy pass: the paper's Table-I
#: speculation point through the policy layer, and the adaptive config.
_SPEC_FRONTENDS = (
    ("fixed4", SimConfig("spec-fixed4", in_flight=DEFAULT_DEPTH,
                         prefetch=FixedDepth(DEFAULT_DEPTH))),
    ("adaptive", SimConfig.adaptive()),
)

@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Fully determines one sweep (and hence one baseline document)."""

    mode: str
    seed: int
    repeats: int
    archs: Sequence[str]
    workloads: Sequence[str]
    channel_counts: Sequence[int]
    mem_latencies: Sequence[int]
    include_serve: bool = False
    mesh_sizes: Sequence[int] = MESH_SIZES
    include_sharded: bool = False
    #: In-flight transform cells (schema v6, DESIGN.md §9).
    include_transforms: bool = True
    #: Chain-lowering JIT (DESIGN.md §7). False reproduces the uncached
    #: legacy dispatch path: hit rate 0.0 and launch speedup 1.0.
    translation: bool = True
    #: MMU/IOTLB cells (schema v8, DESIGN.md §11); False skips them and
    #: the document records ``iotlb_enabled: false``.
    iotlb: bool = True

    @property
    def scale(self) -> Scale:
        return SCALES[self.mode]


def default_spec(
    mode: str = "quick",
    seed: int = 0,
    *,
    archs: Optional[Sequence[str]] = None,
    workloads: Optional[Sequence[str]] = None,
    channel_counts: Optional[Sequence[int]] = None,
    mem_latencies: Optional[Sequence[int]] = None,
    repeats: Optional[int] = None,
    include_serve: bool = False,
    mesh_sizes: Optional[Sequence[int]] = None,
    include_sharded: bool = False,
    include_transforms: bool = True,
    translation: bool = True,
    iotlb: bool = True,
) -> SweepSpec:
    if mode not in SCALES:
        raise ValueError(f"unknown mode {mode!r}; have {sorted(SCALES)}")
    quick = mode == "quick"
    return SweepSpec(
        mode=mode,
        seed=seed,
        repeats=repeats if repeats is not None else (3 if quick else 5),
        archs=tuple(archs if archs is not None else list_archs()),
        workloads=tuple(workloads if workloads is not None else WORKLOAD_NAMES),
        channel_counts=tuple(channel_counts if channel_counts is not None
                             else ((4,) if quick else (1, 2, 4))),
        mem_latencies=tuple(mem_latencies if mem_latencies is not None
                            else ((13, 100) if quick else (1, 13, 100))),
        include_serve=include_serve,
        mesh_sizes=tuple(mesh_sizes if mesh_sizes is not None
                         else MESH_SIZES),
        include_sharded=include_sharded,
        include_transforms=include_transforms,
        translation=translation,
        iotlb=iotlb,
    )


def cell_key(arch: str, workload: str, channels: int, mem_latency: int) -> str:
    return f"{arch}/{workload}/ch{channels}/L{mem_latency}"


_NONDETERMINISTIC_COUNTERS = ("drain_seconds", "launch_seconds")


def _deterministic_counters(snapshot: Dict[str, object]) -> Dict[str, object]:
    """Strip wall-clock fields so the stored document is seed-pure."""
    out: Dict[str, object] = {}
    for name, c in snapshot["channels"].items():
        out[name] = {k: v for k, v in c.items()
                     if k not in _NONDETERMINISTIC_COUNTERS}
    return out


def _run_runtime_pass(arch: str, workload: str, channels: int,
                      scale: Scale, seed: int, *,
                      translation: bool = True,
                      device=None) -> Dict[str, object]:
    cfg = get_config(arch)
    wl = generate(workload, cfg, scale, seed)
    probe = PerfProbe()
    rt = DMARuntime(
        [ChannelConfig(name=f"ch{i}", tier="serial",
                       ring_capacity=scale.ring_capacity,
                       max_len=scale.max_len)
         for i in range(channels)],
        arbitration="round_robin", backpressure="block",
        translation=translation, device=device)
    rt.attach_probe(probe)
    for name in ("src", "dst"):
        rt.register_pool(name, torch.zeros(wl.pool_elems, dtype=torch.float32,
                                           device=rt.device))

    def submit_all():
        for d in wl.chains:
            rt.submit(SubmitRequest(chain=d, src_pool="src",
                                    dst_pool="dst", tier="serial"))
        rt.drain_until_idle()

    submit_all()                       # cold round: plans + artifacts compile
    cold = rt._translation_stats_raw()
    warm_rounds = _WARM_ROUNDS if translation else 0
    for _ in range(warm_rounds):       # serve-shaped replays: same chains
        submit_all()
    warm = rt._translation_stats_raw()
    d_lookups = int(warm["lookups"]) - int(cold["lookups"])
    d_hits = int(warm["hits"]) - int(cold["hits"])
    steady_hit_rate = d_hits / d_lookups if d_lookups else 0.0

    st = rt.stats()
    return {
        "merge_ratio": float(st["coalesce_merge_ratio"]),
        "hit_rate": float(st["mean_input_hit_rate"]),
        "launch_us_per_descriptor": float(st["launch_us_per_descriptor"]),
        "translation_hit_rate": float(steady_hit_rate),
        "transfer_bytes": wl.transfer_bytes,
        "counters": {
            **_deterministic_counters(probe.snapshot()),
            # Deterministic event counts of the chain-lowering JIT
            # (DESIGN.md §7) over the cold round plus all warm replays.
            "translation_cache": warm,
        },
    }


def _speculation_pass(mem_latency: int, transfer_bytes: int,
                      hit_rate: float, num_transfers: int):
    """Adaptive-vs-fixed cycle-model cells (DESIGN.md §5).

    The gated metric is *contention-discounted* utilization: steady-state
    utilization times the useful share of all descriptor traffic
    (``payload / (payload + desc_beats)``, where ``desc_beats`` includes
    discarded speculative fetches), normalized by the Eq.-1 ideal so a
    zero-waste frontend reports its plain utilization.
    """
    metrics: Dict[str, float] = {}
    trajectory: Dict[str, Dict[str, float]] = {}
    for label, cfg in _SPEC_FRONTENDS:
        r = simulate(cfg, mem_latency, transfer_bytes,
                     num_transfers=num_transfers, hit_rate=hit_rate)
        useful = r.payload_beats / max(r.payload_beats + r.desc_beats, 1)
        metrics[f"spec_bus_utilization_{label}"] = float(
            r.utilization * useful / r.ideal)
        trajectory[label] = {
            "final_depth": int(r.final_depth),
            "mean_depth": float(r.mean_depth),
            "wasted_beats": int(r.wasted_beats),
        }
    return metrics, trajectory


def _translation_pass(mem_latency: int, transfer_bytes: int,
                      num_transfers: int) -> float:
    """Launch speedup of a cached lowered chain, from the cycle model:
    ``SimConfig.base()`` (§II-A next-field serialization on every fetch)
    over ``SimConfig.translated_frontend()`` (every address known, fetches
    back to back), as a ratio of total cycles."""
    base = simulate(SimConfig.base(), mem_latency, transfer_bytes,
                    num_transfers=num_transfers)
    translated = simulate(SimConfig.translated_frontend(), mem_latency,
                          transfer_bytes, num_transfers=num_transfers)
    return float(base.cycles / max(translated.cycles, 1))


def run_sweep(spec: Optional[SweepSpec] = None, *,
              progress: bool = False, device=None,
              launch_us: Optional[Dict[str, List[float]]] = None
              ) -> Dict[str, object]:
    """Execute the sweep; returns the BENCH_perf document (JSON-ready).

    The runtime passes run on ``device`` (``cuda`` unless given). When
    ``launch_us`` is a dict, it receives each ``arch/workload/chN`` runtime
    pass's host wall-clock ``launch_us_per_descriptor``, one per repeat;
    wall-clock numbers never enter the document.
    """
    spec = spec or default_spec()
    scale = spec.scale
    cells: Dict[str, Dict[str, object]] = {}
    # The speculation pass depends only on (L, transfer size, hit rate) and
    # the translation pass only on (L, transfer size): memoize both.
    spec_cache: Dict[tuple, tuple] = {}
    translation_cache_pass: Dict[tuple, float] = {}

    for arch in spec.archs:
        for workload in spec.workloads:
            for channels in spec.channel_counts:
                # The runtime pass is independent of memory latency; run it
                # once per repeat and fan metrics out over the L axis.
                passes = [
                    _run_runtime_pass(arch, workload, channels, scale,
                                      spec.seed + r,
                                      translation=spec.translation,
                                      device=device)
                    for r in range(spec.repeats)
                ]
                merge = float(np.median([p["merge_ratio"] for p in passes]))
                hit = float(np.median([p["hit_rate"] for p in passes]))
                cache_hit = float(np.median(
                    [p["translation_hit_rate"] for p in passes]))
                # transfer_bytes is a pure function of (arch, workload): the
                # cycle model runs once per cell, not once per repeat.
                transfer_bytes = passes[0]["transfer_bytes"]
                assert all(p["transfer_bytes"] == transfer_bytes
                           for p in passes), \
                    "transfer_bytes became seed-dependent"
                wall = [p["launch_us_per_descriptor"] for p in passes]
                if launch_us is not None:
                    launch_us[f"{arch}/{workload}/ch{channels}"] = wall
                if progress:
                    print(f"  {arch}/{workload}/ch{channels}: launch "
                          f"{np.median(wall):.2f} us/desc (wall-clock, "
                          "unstored)", file=sys.stderr)
                for mem_latency in spec.mem_latencies:
                    sim = simulate_multichannel(
                        channels, mem_latency, transfer_bytes,
                        num_transfers=scale.sim_transfers)
                    spec_key = (mem_latency, transfer_bytes, hit,
                                scale.sim_transfers)
                    if spec_key not in spec_cache:
                        spec_cache[spec_key] = _speculation_pass(*spec_key)
                    spec_metrics, trajectory = spec_cache[spec_key]
                    if spec.translation:
                        tr_key = (mem_latency, transfer_bytes,
                                  scale.sim_transfers)
                        if tr_key not in translation_cache_pass:
                            translation_cache_pass[tr_key] = \
                                _translation_pass(*tr_key)
                        speedup = translation_cache_pass[tr_key]
                    else:
                        speedup = 1.0
                    total = channels * scale.sim_transfers
                    key = cell_key(arch, workload, channels, mem_latency)
                    cells[key] = {
                        "kind": "dma",
                        "arch": arch,
                        "workload": workload,
                        "channels": channels,
                        "mem_latency": mem_latency,
                        "metrics": {
                            "bus_utilization":
                                float(sim.aggregate_utilization),
                            "launch_cycles_per_transfer":
                                float(sim.cycles / total),
                            "coalesce_merge_ratio": merge,
                            "speculation_hit_rate": hit,
                            "translation_cache_hit_rate": cache_hit,
                            "translation_launch_speedup": speedup,
                            **spec_metrics,
                        },
                        "speculation": trajectory,
                        "counters": passes[0]["counters"],
                    }
                    if progress:
                        m = cells[key]["metrics"]
                        print(f"  {key}: util={m['bus_utilization']:.3f} "
                              f"merge={merge:.2f} hit={hit:.2f} "
                              f"cache={cache_hit:.2f} "
                              f"speedup={speedup:.2f}x", file=sys.stderr)

    serve_cells = []
    if spec.include_serve:
        serve_spec = DEFAULT_SERVE_SPEC
        serve_metrics, serve_counters = run_serve_cell(
            spec.seed, serve_spec, device=device)
        serve_cells = [serve_spec.cell_key]
        cells[serve_spec.cell_key] = {
            "kind": "serve",
            "arch": serve_spec.arch,
            "workload": "serve",
            "capacity": serve_spec.capacity,
            "n_requests": serve_spec.n_requests,
            "metrics": serve_metrics,
            "counters": serve_counters,
        }
        if progress:
            print(f"  {serve_spec.cell_key}: " + " ".join(
                f"{k}={v:.3f}" for k, v in serve_metrics.items()
                if isinstance(v, (int, float))),
                file=sys.stderr)

    sharded_cells = []
    if spec.include_sharded:
        for mesh in spec.mesh_sizes:
            key, cell = sharded_cell_entry(
                spec.seed, mesh, DEFAULT_SHARDED_SPEC,
                repeats=spec.repeats, device=device)
            cells[key] = cell
            sharded_cells.append(key)
            if progress:
                print(f"  {key}: " + " ".join(
                    f"{k}={v:.3f}" for k, v in cell["metrics"].items()),
                    file=sys.stderr)

    mmu_cells = []
    if spec.iotlb:
        for key, cell in mmu_cell_entries(spec.seed, spec.mem_latencies,
                                          DEFAULT_MMU_SPEC):
            cells[key] = cell
            mmu_cells.append(key)

    transform_cells = []
    if spec.include_transforms:
        for key, cell in transform_cell_entries(
                spec.seed, DEFAULT_TRANSFORM_SPEC,
                quick=spec.mode == "quick", device=device):
            cells[key] = cell
            transform_cells.append(key)

    if progress:
        for key in mmu_cells + transform_cells:
            print(f"  {key}: " + " ".join(
                f"{k}={v:.3f}" for k, v in cells[key]["metrics"].items()),
                file=sys.stderr)

    return {
        "schema_version": SCHEMA_VERSION,
        "mode": spec.mode,
        "seed": spec.seed,
        "repeats": spec.repeats,
        "translation_cache_enabled": spec.translation,
        "iotlb_enabled": spec.iotlb,
        "dimensions": {
            "archs": list(spec.archs),
            "workloads": list(spec.workloads),
            "channel_counts": list(spec.channel_counts),
            "mem_latencies": list(spec.mem_latencies),
            "serve_cells": serve_cells,
            "mesh_sizes": list(spec.mesh_sizes),
            "sharded_cells": sharded_cells,
            "transform_cells": transform_cells,
            "mmu_cells": mmu_cells,
        },
        "gated_metrics": list(GATED_METRICS),
        "serve_gated_metrics": list(SERVE_GATED_METRICS),
        "sharded_gated_metrics": list(SHARDED_GATED_METRICS),
        "transform_gated_metrics": list(TRANSFORM_GATED_METRICS),
        "mmu_gated_metrics": list(MMU_GATED_METRICS),
        "cells": cells,
    }


def spec_from_doc(doc: Dict[str, object]) -> SweepSpec:
    """Rebuild the exact spec a document was generated with."""
    dims = doc["dimensions"]
    return default_spec(
        doc["mode"], int(doc["seed"]),
        archs=dims["archs"], workloads=dims["workloads"],
        channel_counts=dims["channel_counts"],
        mem_latencies=dims["mem_latencies"],
        repeats=int(doc["repeats"]),
        include_serve=bool(dims.get("serve_cells")),
        mesh_sizes=dims.get("mesh_sizes", MESH_SIZES),
        include_sharded=bool(dims.get("sharded_cells")),
        include_transforms=bool(dims.get("transform_cells")),
        translation=bool(doc.get("translation_cache_enabled", True)),
        iotlb=bool(doc.get("iotlb_enabled", True)),
    )


def write_doc(doc: Dict[str, object], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


DEFAULT_OUT = os.path.join("build", "BENCH_perf.port.json")
#: The reference's committed baseline: read by the gate, never written.
COMMITTED_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
    "BENCH_perf.json")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.perf.sweep",
        description="Run the port's scenario sweep and write its document "
                    "(never over the committed BENCH_perf.json).")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"output path (default {DEFAULT_OUT})")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--quick", dest="mode", action="store_const",
                      const="quick", help="reduced CI sweep (default)")
    mode.add_argument("--full", dest="mode", action="store_const",
                      const="full", help="full baseline sweep")
    ap.set_defaults(mode="quick")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--no-translation-cache", action="store_true",
                    help="run the legacy uncached dispatch path (hit rate "
                         "0.0, speedup 1.0; recorded in the document)")
    ap.add_argument("--no-iotlb", action="store_true",
                    help="skip the MMU/IOTLB cells; recorded as "
                         "iotlb_enabled=false in the document")
    ap.add_argument("--progress", action="store_true")
    args = ap.parse_args(argv)

    if os.path.realpath(args.out) == os.path.realpath(COMMITTED_BASELINE):
        print("refusing to write BENCH_perf.json: the committed baseline is "
              "the reference's; pass another --out", file=sys.stderr)
        return 2
    doc = run_sweep(default_spec(args.mode, args.seed, include_serve=True,
                                 include_sharded=True,
                                 translation=not args.no_translation_cache,
                                 iotlb=not args.no_iotlb),
                    progress=args.progress, device=args.device)
    write_doc(doc, args.out)
    print(f"wrote {args.out}: {len(doc['cells'])} cells "
          f"(mode={args.mode}, seed={args.seed})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
