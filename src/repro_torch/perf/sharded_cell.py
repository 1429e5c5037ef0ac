"""Sharded mesh cells of the perf sweep (DESIGN.md §6, §10).

One cell per mesh size in {1, 2, 4, 8}: Zipf-skewed page migration over a
page space partitioned across that many shards, lowered through the real
:class:`repro_torch.distributed.ShardedKVPool` /
:class:`repro_torch.distributed.ShardedDMARuntime` with the **async fabric**
(each cross-shard hop a non-blocking ticket over per-link occupancy,
DESIGN.md §10), plus the sharded cycle model
(:func:`repro_torch.core.simulator.simulate_sharded`) in both interconnect
modes — ``contended`` (per-directed-link buses, matching the fabric) is
the gated number, ``shared`` (the PR-8 one-bus model, matching the
synchronous fabric) is stored as the synchronous baseline.

Gated metrics (schema v7):

* ``migration_chain_merge_ratio`` — descriptors in / out of the
  migration plan's chains (the runtime coalescer), median over repeats.
* ``per_shard_bus_utilization`` — mean shard-local steady-state bus
  utilization from the cycle model.
* ``cross_shard_migration_cycles`` — mean added interconnect cycles per
  migrated transfer, contended mode; 0.0 at mesh 1 by construction.
* ``migration_overlap_ratio`` — fraction of fabric in-flight rounds
  hidden behind shard-local drain progress, from the real async runtime
  (``MigrationStats.overlap_ratio``), median over repeats; 0.0 at mesh 1.
  Hard floor: **>= 0.6 at mesh >= 4** (in-cell RuntimeError).
* ``p99_migration_stall_cycles`` — p99 added interconnect cycles,
  contended mode.  Hard invariant at mesh >= 4: **strictly below** the
  shared-bus (synchronous-fabric) p99 stored in the counters.
* ``rebalance_convergence_steps`` — traffic steps until the
  :class:`repro_torch.distributed.RebalancePlanner` hysteresis episode closes
  on an adversarial hot-shard Zipf workload (heat concentrated on shard
  0); 0 at mesh 1.
* ``throughput_retained_during_resize`` — pump rounds to complete a
  foreground migration workload alone / with a concurrent
  background-priority resize handoff off the last shard; 1.0 at mesh 1.
  Hard floor: **>= 0.8 at mesh >= 4** (the mesh-4 cell measures 4 -> 3).
* ``first_touch_latency_rounds`` (schema v8, DESIGN.md §11) — fabric
  rounds from the first touch of an ownership-flipped page to residency
  (the lazy pull through ``ensure_resident``); 0.0 at mesh 1.  Hard
  invariant at mesh >= 4: **strictly below** the rounds of a full
  synchronous migration of the same batch.

Determinism contract: identical to the DMA cells — every number is a
pure function of ``(seed, cell_key)``: the fabric runs on a logical
round clock, the planner and cycle model are seeded from the cell key,
device *placement* never enters any metric, and no wall-clock value is
stored.  ``ShardedCellSpec(fabric="sync")`` is the escape hatch: the
runtime passes lower through the PR-8 synchronous hop path and the
fabric-dependent metrics pin to their mesh-1 values.

The runtimes' pools live on the sweep's device (``cuda`` unless the
caller passes ``device="cpu"``); on the card the drains of uniform,
unit-aligned page rows go through the ``descriptor_copy`` kernel.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.simulator import simulate_sharded
from repro_torch.perf.workloads import arch_params, zipf_page_traffic

#: Gated sharded-cell metrics (gate.py carries polarity + bands).
SHARDED_GATED_METRICS = (
    "cross_shard_migration_cycles",
    "per_shard_bus_utilization",
    "migration_chain_merge_ratio",
    "migration_overlap_ratio",
    "p99_migration_stall_cycles",
    "rebalance_convergence_steps",
    "throughput_retained_during_resize",
    "first_touch_latency_rounds",
)

#: The mesh axis of the sweep — matches the CI lane's 8 emulated devices.
MESH_SIZES = (1, 2, 4, 8)

#: In-cell hard floors at mesh >= 4 (enforced with RuntimeError so the
#: gate can never compare a cell that silently lost its async overlap).
MIN_OVERLAP_RATIO = 0.6
MIN_RETAINED_THROUGHPUT = 0.8


@dataclasses.dataclass(frozen=True)
class ShardedCellSpec:
    """Fully determines one mesh cell (and hence its baseline entry)."""

    arch: str = "qwen2.5-3b"
    pages_per_shard: int = 64
    n_moves: int = 96            # page moves per migration pass
    zipf_alpha: float = 1.1      # rank exponent of the page-traffic skew
    traffic_len: int = 256       # Zipf touches per traffic step
    channels_per_shard: int = 2
    mem_latency: int = 13
    sim_transfers: int = 200
    max_len: int = 512           # serial-channel burst window (elements)
    fabric: str = "async"        # "sync" = PR-8 escape hatch
    fabric_latency: int = 1
    fabric_page_beats: int = 1
    wave: int = 8                # moves per migrate_rows plan (pipelining)
    rebalance_window: int = 4
    rebalance_alpha: float = 0.9   # sustained-load skew (milder than moves)
    rebalance_traffic_len: int = 1024  # touches per load sample (noise floor)
    max_rebalance_steps: int = 64
    handoff_pages: int = 32      # resize handoff size (<= pages_per_shard/2)
    handoff_chunk: int = 4       # pages per background handoff plan
    handoff_period: int = 3      # pump rounds between handoff chunks

    def cell_key(self, mesh: int) -> str:
        return f"sharded/{self.arch}/mesh{mesh}"


DEFAULT_SHARDED_SPEC = ShardedCellSpec()


def _mesh_for(num_shards: int, device=None):
    """A real 1-D mesh of ``num_shards`` CUDA devices when the sweep runs on
    CUDA and the host has that many, else None (logical shards on the one
    device — metrics are placement-independent either way)."""
    from repro_torch.device import resolve_device
    from repro_torch.distributed.shardlib import Mesh
    if resolve_device(device).type != "cuda" \
            or not 1 < num_shards <= torch.cuda.device_count():
        return None
    return Mesh([torch.device("cuda", i) for i in range(num_shards)],
                ("dma",))


def _make_runtime(mesh: int, spec: ShardedCellSpec, device=None):
    from repro_torch.distributed.sharded_runtime import (
        ShardedDMARuntime, ShardedKVPool)
    cfg = get_config(spec.arch)
    p = arch_params(cfg)
    rt = ShardedDMARuntime(num_shards=mesh, mesh=_mesh_for(mesh, device),
                           data_channels=spec.channels_per_shard,
                           max_len=spec.max_len,
                           fabric=spec.fabric,
                           fabric_latency=spec.fabric_latency,
                           fabric_page_beats=spec.fabric_page_beats,
                           device=device)
    kv = ShardedKVPool(rt, num_pages=spec.pages_per_shard * mesh,
                       page=p.page_elems, kv_heads=1, head_dim=1)
    return rt, kv, p


def _zipf_moves(rng: np.random.Generator, num_pages: int, n_moves: int,
                alpha: float, traffic_len: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Zipf-skewed migration plan: the hottest distinct pages of a seeded
    Zipf reference stream relocate onto untouched (cold) pages — hot
    content chases free space, the steady state of a paged KV cache
    under skewed request popularity."""
    traffic = zipf_page_traffic(num_pages, traffic_len, alpha=alpha,
                                rng=rng)
    pages, counts = np.unique(traffic, return_counts=True)
    hot = pages[np.argsort(-counts, kind="stable")]
    cold = np.setdiff1d(np.arange(num_pages, dtype=np.int64), hot)
    n = min(n_moves, len(hot), len(cold))
    if n == 0:
        raise RuntimeError("Zipf traffic covered the whole page space; "
                           "no cold destination pages left")
    src = hot[:n]
    dst = rng.permutation(cold)[:n]
    return src.astype(np.int64), dst.astype(np.int64)


def _cell_rng(seed: int, mesh: int, spec: ShardedCellSpec,
              salt: str = "") -> np.random.Generator:
    return np.random.default_rng(
        [seed, mesh, zlib.crc32((spec.cell_key(mesh) + salt).encode())])


def _submit_waves(kv, src: List[int], dst: List[int], wave: int,
                  priority: int) -> List[object]:
    """Submit a move set as ``wave``-sized plans with no intermediate
    drain: independent hops pipeline on the fabric instead of fusing
    into one monolithic transfer per shard pair, so delivered waves
    scatter locally while later waves are still on the wire — the
    overlap the async fabric exists to expose."""
    out = []
    for i in range(0, len(src), wave):
        out.append(kv.move_pages(kv.refs(src[i:i + wave]),
                                 kv.refs(dst[i:i + wave]),
                                 priority=priority, drain=False))
    return out


def _migration_pass(seed: int, mesh: int, spec: ShardedCellSpec,
                    device=None) -> Dict[str, float]:
    """One seeded Zipf migration through the real sharded runtime."""
    rng = _cell_rng(seed, mesh, spec)
    rt, kv, p = _make_runtime(mesh, spec, device)
    src, dst = _zipf_moves(rng, spec.pages_per_shard * mesh, spec.n_moves,
                           spec.zipf_alpha, spec.traffic_len)
    if spec.fabric == "async":
        _submit_waves(kv, src.tolist(), dst.tolist(), spec.wave,
                      priority=1)
        rt.pump_until_idle()
        rt.drain_until_idle()
    else:
        # Escape hatch: one monolithic plan through the PR-8 blocking
        # hop path, exactly as the v6 cell lowered it.
        kv.move_pages(src.tolist(), dst.tolist())
    # The waves all merged into the mesh aggregate at submit time; the
    # aggregate is the pass (fresh runtime per pass).
    agg = rt.migration
    if agg.hop_completions != agg.hops:
        # Not an assert: the gate must catch this even under python -O.
        raise RuntimeError(
            "a cross-shard hop finished without its §II-D writeback "
            f"({agg.hop_completions}/{agg.hops}) — the cell would "
            "gate garbage")
    return {
        "merge_ratio": agg.merge_ratio,
        "cross_fraction": agg.cross_pages / max(agg.pages, 1),
        "overlap_ratio": agg.overlap_ratio,
        "inflight_rounds": agg.fabric_inflight_rounds,
        "hidden_rounds": agg.fabric_hidden_rounds,
        "fabric_rounds": rt.fabric.now if rt.fabric is not None else 0,
        "pages": agg.pages,
        "cross_pages": agg.cross_pages,
        "hops": agg.hops,
        "chain_in": agg.chain_in,
        "chain_out": agg.chain_out,
        "transfer_bytes": p.page_elems * 4,   # float32 page rows
    }


def _rebalance_convergence(seed: int, mesh: int, spec: ShardedCellSpec,
                           device=None) -> Dict[str, float]:
    """Traffic steps until the planner's hysteresis episode closes.

    Adversarial placement: Zipf rank r maps to page r, so the whole hot
    head starts on shard 0.  Each step samples one traffic window,
    feeds the planner per-shard touch counts, and applies any emitted
    plan through the real migration path; references follow the content
    (``loc``), so spreading the hot head across the mesh is what brings
    the windowed imbalance back under ``low_water``.
    """
    from repro_torch.distributed.fabric import RebalancePlanner

    if mesh == 1 or spec.fabric != "async":
        return {"steps": 0, "plans": 0, "pages_planned": 0,
                "final_imbalance": 1.0}
    rng = _cell_rng(seed, mesh, spec, salt="/rebalance")
    rt, kv, _ = _make_runtime(mesh, spec, device)
    num_pages = spec.pages_per_shard * mesh
    planner = RebalancePlanner(mesh, window=spec.rebalance_window)
    # Zipf rank r maps to page r (hot_pages=loc starts as the identity),
    # so the whole hot head begins on shard 0 — the adversarial start.
    loc = np.arange(num_pages, dtype=np.int64)   # logical -> physical
    steps = plans = 0
    for step in range(1, spec.max_rebalance_steps + 1):
        touches = zipf_page_traffic(num_pages, spec.rebalance_traffic_len,
                                    alpha=spec.rebalance_alpha, rng=rng,
                                    hot_pages=loc)
        load = np.bincount(touches // spec.pages_per_shard,
                           minlength=mesh).astype(float)
        planner.observe(load.tolist(), hot_pages=touches.tolist())
        plan = planner.plan(kv)
        if plan is not None:
            src, dst = plan
            kv.move_pages(kv.refs(src), kv.refs(dst), priority=0)
            remap = dict(zip(src, dst))
            loc = np.asarray([remap.get(int(p), int(p)) for p in loc],
                             np.int64)
            plans += 1
        elif plans and not planner.should_rebalance():
            steps = step
            break
    else:
        steps = spec.max_rebalance_steps
    return {"steps": steps, "plans": plans,
            "pages_planned": planner.pages_planned,
            "final_imbalance": planner.imbalance()}


def _pump_plans(srt, plans, max_rounds: int = 65536) -> int:
    """Pump rounds until every fabric hop of the given plans completed."""
    rounds = 0
    while any(srt.plan_outstanding(s) for s in plans):
        srt.pump()
        rounds += 1
        if rounds > max_rounds:
            raise RuntimeError("migration plan did not quiesce")
    return rounds


def _resize_retention(seed: int, mesh: int, spec: ShardedCellSpec,
                      device=None) -> Dict[str, float]:
    """Foreground rounds alone vs. during a background resize handoff.

    Two fresh same-seed runtimes run the identical Zipf foreground
    workload; the second also carries a background-priority handoff of
    the last shard's pages (mesh N -> N-1) through the same fabric.
    Retention is the round ratio — per-link occupancy is the only thing
    that can slow the foreground down, which is exactly what the metric
    watches.
    """
    if mesh == 1 or spec.fabric != "async":
        return {"retained": 1.0, "rounds_alone": 0, "rounds_during": 0,
                "handoff_pages": 0}
    num_pages = spec.pages_per_shard * mesh
    leaving = mesh - 1

    def _workload(rng: np.random.Generator):
        # Cap the foreground at a quarter of the page space so the
        # leaving shard still has pages left to hand off (the full Zipf
        # move set can touch nearly every page on small meshes).
        return _zipf_moves(rng, num_pages, min(spec.n_moves, num_pages // 4),
                           spec.zipf_alpha, spec.traffic_len)

    # Alone: foreground only.
    rng = _cell_rng(seed, mesh, spec, salt="/resize")
    rt_a, kv_a, _ = _make_runtime(mesh, spec, device)
    src, dst = _workload(rng)
    fg_a = _submit_waves(kv_a, src.tolist(), dst.tolist(), spec.wave,
                         priority=1)
    rounds_alone = _pump_plans(rt_a, fg_a)
    rt_a.drain_until_idle()

    # During: same foreground + background handoff off the leaving shard.
    # The handoff is *paced* — one background-priority chunk per pump
    # round, the way a real rebalancer trickles ownership migration —
    # so it contends for drain slots and link occupancy continuously
    # instead of capturing every channel FIFO up front.
    rng = _cell_rng(seed, mesh, spec, salt="/resize")
    rt_b, kv_b, _ = _make_runtime(mesh, spec, device)
    src2, dst2 = _workload(rng)
    used = set(src2.tolist()) | set(dst2.tolist())
    h_src = [p for p in kv_b.owner.shard_pages(leaving)
             if p not in used][:spec.handoff_pages]
    h_dst = [p for p in range(num_pages)
             if kv_b.owner.owner(p) != leaving
             and p not in used][:len(h_src)]
    if len(h_dst) < len(h_src):
        h_src = h_src[:len(h_dst)]
    chunks = [(h_src[i:i + spec.handoff_chunk],
               h_dst[i:i + spec.handoff_chunk])
              for i in range(0, len(h_src), spec.handoff_chunk)]
    fg_b = _submit_waves(kv_b, src2.tolist(), dst2.tolist(), spec.wave,
                         priority=1)
    handoff = []
    rounds_during = 0
    while any(rt_b.plan_outstanding(s) for s in fg_b):
        if chunks and rounds_during % spec.handoff_period == 0:
            s, d = chunks.pop(0)
            handoff.append(kv_b.move_pages(kv_b.refs(s), kv_b.refs(d),
                                           priority=0, drain=False))
        rt_b.pump()
        rounds_during += 1
        if rounds_during > 65536:
            raise RuntimeError("resize foreground did not quiesce")
    for s, d in chunks:   # tail of the handoff after the foreground
        handoff.append(kv_b.move_pages(kv_b.refs(s), kv_b.refs(d),
                                       priority=0, drain=False))
    rt_b.pump_until_idle()
    rt_b.drain_until_idle()
    lost = [(s.hop_completions, s.hops) for s in handoff
            if s.hop_completions != s.hops]
    if lost:
        raise RuntimeError(
            f"resize handoff lost a §II-D writeback ({lost})")
    retained = (min(1.0, rounds_alone / rounds_during)
                if rounds_during else 1.0)
    return {"retained": retained, "rounds_alone": rounds_alone,
            "rounds_during": rounds_during, "handoff_pages": len(h_src)}


def _first_touch_latency(seed: int, mesh: int, spec: ShardedCellSpec,
                         device=None) -> Dict[str, float]:
    """Ownership-first migration (DESIGN.md §11): fabric rounds from the
    first touch of a flipped page to residency, vs the rounds a full
    synchronous migration of the same batch costs.

    Two same-seed pools each hold one written batch on shard 0.  The
    synchronous leg migrates the whole batch eagerly and counts fabric
    rounds to quiescence.  The lazy leg flips the batch's *ownership* to
    shard 1 (a page-table write — zero rounds) and then touches one
    page: ``ensure_resident`` pulls exactly that page through the
    normal fabric path.  The gated number is the touch-to-resident
    rounds — bounded by one page's hop, not the batch.
    """
    if mesh == 1 or spec.fabric != "async":
        return {"first_touch_rounds": 0.0, "sync_rounds": 0.0,
                "batch_pages": 0, "pulled": 0}
    rng = _cell_rng(seed, mesh, spec, salt="/firsttouch")
    batch = min(spec.handoff_pages, spec.pages_per_shard // 2)
    rows = rng.standard_normal((batch,)).astype(np.float32)

    def _filled():
        rt, kv, p = _make_runtime(mesh, spec, device)
        pages = kv.alloc_on(0, batch)
        for i, pg in enumerate(pages):
            row = np.full(kv.row_elems, rows[i], np.float32)
            kv.write_page(pg, row, -row)
        return rt, kv, pages

    # Synchronous leg: eager batch migration, rounds to quiescence.
    rt_s, kv_s, pages_s = _filled()
    dst = kv_s.alloc_on(1, batch)
    base = rt_s.fabric.now
    kv_s.move_pages(pages_s, dst, priority=1)
    sync_rounds = rt_s.fabric.now - base

    # Lazy leg: flip ownership now, pull one page on first touch.
    rt_l, kv_l, pages_l = _filled()
    flipped = kv_l.flip_ownership(pages_l, 1)
    base = rt_l.fabric.now
    k_one, _ = kv_l.page_rows([flipped[0]])
    first_rounds = rt_l.fabric.now - base
    if not np.allclose(k_one[0], np.full(kv_l.row_elems, rows[0])):
        raise RuntimeError(
            "first-touch pull delivered wrong page contents — the lazy "
            "migration path is corrupting pages")
    pulled = kv_l.first_touch_pulls
    if pulled != 1:
        raise RuntimeError(
            f"touching one flipped page pulled {pulled} pages — "
            "first touch is not lazy")
    return {"first_touch_rounds": float(first_rounds),
            "sync_rounds": float(sync_rounds),
            "batch_pages": batch, "pulled": pulled}


def run_sharded_cell(
    seed: int,
    mesh: int,
    spec: ShardedCellSpec = DEFAULT_SHARDED_SPEC,
    *,
    repeats: int = 3,
    device=None,
) -> Tuple[Dict[str, float], Dict[str, object]]:
    """Run one mesh cell; returns ``(gated_metrics, stored_counters)``.

    Migration-pass numbers are medians over ``repeats`` seeded passes
    (the same convention as the DMA cells); the cycle model, the
    rebalance-convergence loop, and the resize pair each run once at the
    base seed. The runtimes run on ``device`` (``cuda`` unless given).
    """
    passes = [_migration_pass(seed + r, mesh, spec, device)
              for r in range(repeats)]
    merge = float(np.median([p["merge_ratio"] for p in passes]))
    cross = float(np.median([p["cross_fraction"] for p in passes]))
    overlap = float(np.median([p["overlap_ratio"] for p in passes]))
    transfer_bytes = int(passes[0]["transfer_bytes"])
    sim_seed = zlib.crc32(spec.cell_key(mesh).encode()) & 0x7FFFFFFF

    def _sim(mode: str):
        return simulate_sharded(
            mesh, spec.channels_per_shard, spec.mem_latency, transfer_bytes,
            num_transfers=spec.sim_transfers, cross_fraction=cross,
            interconnect_mode=mode, seed=sim_seed).sharded

    contended = _sim("contended")
    shared = _sim("shared")     # the synchronous-fabric baseline

    rebalance = _rebalance_convergence(seed, mesh, spec, device)
    resize = _resize_retention(seed, mesh, spec, device)
    first_touch = _first_touch_latency(seed, mesh, spec, device)

    if mesh >= 4 and spec.fabric == "async":
        if not (first_touch["first_touch_rounds"]
                < first_touch["sync_rounds"]):
            ft, sr = (first_touch["first_touch_rounds"],
                      first_touch["sync_rounds"])
            raise RuntimeError(
                f"first-touch latency ({ft:.0f} rounds) is not below a "
                f"full synchronous migration ({sr:.0f} rounds) at mesh "
                f"{mesh} — ownership-first migration lost its point")
        if overlap < MIN_OVERLAP_RATIO:
            raise RuntimeError(
                f"async fabric hid only {overlap:.3f} of its in-flight "
                f"rounds at mesh {mesh} (floor {MIN_OVERLAP_RATIO}) — "
                "migration is not overlapping with local drains")
        if not (contended.migration_cycles_p99
                < shared.migration_cycles_p99):
            raise RuntimeError(
                "contended-interconnect p99 stall "
                f"({contended.migration_cycles_p99:.1f}) is not below the "
                f"synchronous shared-bus baseline "
                f"({shared.migration_cycles_p99:.1f}) at mesh {mesh}")
        if resize["retained"] < MIN_RETAINED_THROUGHPUT:
            raise RuntimeError(
                f"foreground throughput retained only "
                f"{resize['retained']:.3f} during resize at mesh {mesh} "
                f"(floor {MIN_RETAINED_THROUGHPUT})")

    metrics = {
        "cross_shard_migration_cycles":
            float(contended.migration_cycles_mean),
        "per_shard_bus_utilization":
            float(contended.mean_shard_utilization),
        "migration_chain_merge_ratio": merge,
        "migration_overlap_ratio": overlap,
        "p99_migration_stall_cycles":
            float(contended.migration_cycles_p99),
        "rebalance_convergence_steps": float(rebalance["steps"]),
        "throughput_retained_during_resize": float(resize["retained"]),
        "first_touch_latency_rounds":
            float(first_touch["first_touch_rounds"]),
    }
    counters = {
        "mesh": mesh,
        "cross_fraction": cross,
        "fabric": {
            "mode": spec.fabric,
            "latency": spec.fabric_latency,
            "page_beats": spec.fabric_page_beats,
            "inflight_rounds": int(passes[0]["inflight_rounds"]),
            "hidden_rounds": int(passes[0]["hidden_rounds"]),
            "rounds": int(passes[0]["fabric_rounds"]),
        },
        "migration": {k: int(passes[0][k]) for k in
                      ("pages", "cross_pages", "hops",
                       "chain_in", "chain_out")},
        "rebalance": {k: float(v) for k, v in rebalance.items()},
        "resize": {k: float(v) for k, v in resize.items()},
        "first_touch": {k: float(v) for k, v in first_touch.items()},
        "sync_baseline": {
            "migration_cycles_mean": float(shared.migration_cycles_mean),
            "migration_cycles_p99": float(shared.migration_cycles_p99),
            "interconnect_busy_beats": int(shared.interconnect_busy_beats),
        },
        "sim": {
            "per_shard_utilization":
                [float(u) for u in contended.per_shard_utilization],
            "cross_transfers": int(contended.cross_transfers),
            "interconnect_latency": int(contended.interconnect_latency),
            "interconnect_busy_beats":
                int(contended.interconnect_busy_beats),
            "num_links": int(contended.num_links),
            "link_busy_beats_max": int(contended.link_busy_beats_max),
        },
    }
    return metrics, counters


def cell_entry(seed: int, mesh: int,
               spec: Optional[ShardedCellSpec] = None, repeats: int = 3,
               device=None) -> Tuple[str, Dict[str, object]]:
    """(key, cell dict) for the sweep document."""
    spec = spec or DEFAULT_SHARDED_SPEC
    metrics, counters = run_sharded_cell(seed, mesh, spec, repeats=repeats,
                                         device=device)
    return spec.cell_key(mesh), {
        "kind": "sharded",
        "arch": spec.arch,
        "workload": "kv_migration",
        "mesh": mesh,
        "fabric": spec.fabric,
        "metrics": metrics,
        "counters": counters,
    }
