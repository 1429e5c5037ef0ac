"""MMU cells of the perf sweep (schema v8, DESIGN.md §11).

One cell per memory latency on the sweep's L axis: the §II-C sequential
paged-KV stream driven through the cycle model with the engine-side
IOTLB enabled (:class:`repro_torch.mmu.IOTLBParams`), translation prefetches
riding the speculative descriptor fetch stream — the Kurth et al.
(arXiv 1808.09751) coupling of chain lookahead and page walks.

Gated metrics:

* ``tlb_hit_rate`` — IOTLB hit fraction over all payload translations.
  Hard floor: **>= 0.9** with chain-lookahead prefetch enabled (in-cell
  RuntimeError — a sequential stream whose walks are not hidden means
  the prefetcher detached from the speculator).
* ``walk_stall_cycles`` — total launch cycles spent waiting on page
  walks (prefetch-enabled leg; the demand-walk A/B is in the counters).
* ``defrag_remap_cycles`` vs ``defrag_copy_cycles`` — compacting the
  same fragmented page set by page-table remap
  (:func:`repro_torch.mmu.remap_cycles`: table write + shootdown per page +
  one refill walk) vs the legacy descriptor-chain copy through the §II-B
  engine.  Hard invariant: **remap strictly below copy** on every
  defrag-churn cell (in-cell RuntimeError) — the reason remap-defrag is
  the serve path's default.

Determinism: every number is a pure function of ``(seed, mem_latency)``
through the cycle model — no wall clock, no device placement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core.simulator import SimConfig, simulate
from repro_torch.core.speculation import DEFAULT_DEPTH, FixedDepth
from repro_torch.mmu import IOTLBParams, remap_cycles

#: Gated MMU-cell metrics (gate.py carries polarity + bands).
MMU_GATED_METRICS = (
    "tlb_hit_rate",
    "walk_stall_cycles",
    "defrag_remap_cycles",
    "defrag_copy_cycles",
)

#: In-cell hard floor on the prefetch-enabled sequential stream.
MIN_TLB_HIT_RATE = 0.9


@dataclasses.dataclass(frozen=True)
class MMUCellSpec:
    """Fully determines one MMU cell (and hence its baseline entry)."""

    transfer_bytes: int = 256     # one KV page row per descriptor
    num_transfers: int = 200      # sequential paged-KV chain length
    hit_rate: float = 0.95        # §II-C stream: mostly-sequential pages
    defrag_pages: int = 24        # defrag-churn compaction size

    def cell_key(self, mem_latency: int) -> str:
        return f"mmu/paged_seq/L{mem_latency}"


DEFAULT_MMU_SPEC = MMUCellSpec()


def run_mmu_cell(seed: int, mem_latency: int,
                 spec: MMUCellSpec = DEFAULT_MMU_SPEC
                 ) -> Tuple[Dict[str, float], Dict[str, object]]:
    """Run one MMU cell; returns ``(gated_metrics, stored_counters)``."""
    params = IOTLBParams()                       # chain-lookahead prefetch
    base = SimConfig("ours-mmu", in_flight=DEFAULT_DEPTH,
                     prefetch=FixedDepth(DEFAULT_DEPTH), iotlb=params)
    r = simulate(base, mem_latency, spec.transfer_bytes,
                 num_transfers=spec.num_transfers, hit_rate=spec.hit_rate)
    if r.tlb_hit_rate < MIN_TLB_HIT_RATE:
        raise RuntimeError(
            f"IOTLB hit rate {r.tlb_hit_rate:.3f} under chain-lookahead "
            f"prefetch at L={mem_latency} (floor {MIN_TLB_HIT_RATE}) — "
            "translation prefetches are not riding the §II-C stream")

    # A/B: demand walks only (prefetch depth 0) — stored, not gated.
    demand_cfg = dataclasses.replace(
        base, name="ours-mmu-demand",
        iotlb=IOTLBParams(prefetch=FixedDepth(0)))
    demand = simulate(demand_cfg, mem_latency, spec.transfer_bytes,
                      num_transfers=spec.num_transfers,
                      hit_rate=spec.hit_rate)

    # Defrag churn: compact `defrag_pages` live pages. Remap charges the
    # page-table cost model; copy is a real §II-B chain of page moves
    # through the cycle model (sequential destinations, so the copy leg
    # gets its best case and the invariant is conservative).
    walk = params.resolved_walk_cycles(mem_latency)
    remap = float(remap_cycles(spec.defrag_pages, walk))
    copy_cfg = SimConfig("defrag-copy", in_flight=DEFAULT_DEPTH,
                         prefetch=FixedDepth(DEFAULT_DEPTH))
    copy = float(simulate(copy_cfg, mem_latency, spec.transfer_bytes,
                          num_transfers=spec.defrag_pages,
                          hit_rate=1.0).cycles)
    if not remap < copy:
        raise RuntimeError(
            f"remap-defrag ({remap:.0f} cycles) is not below copy-defrag "
            f"({copy:.0f} cycles) at L={mem_latency} — the remap path "
            "lost its reason to exist")

    metrics = {
        "tlb_hit_rate": float(r.tlb_hit_rate),
        "walk_stall_cycles": float(r.walk_stall_cycles),
        "defrag_remap_cycles": remap,
        "defrag_copy_cycles": copy,
    }
    counters = {
        "mem_latency": mem_latency,
        "iotlb": {
            "entries": params.entries,
            "walk_cycles": walk,
            "prefetch_depth": DEFAULT_DEPTH,
            "tlb_hits": int(r.tlb_hits),
            "tlb_misses": int(r.tlb_misses),
        },
        "demand_walk_baseline": {
            "tlb_hit_rate": float(demand.tlb_hit_rate),
            "walk_stall_cycles": float(demand.walk_stall_cycles),
            "cycles": int(demand.cycles),
        },
        "cycles": int(r.cycles),
        "defrag": {
            "pages": spec.defrag_pages,
            "remap_vs_copy_speedup": copy / max(remap, 1.0),
        },
    }
    return metrics, counters


def mmu_cell_entries(seed: int, mem_latencies,
                     spec: MMUCellSpec = DEFAULT_MMU_SPEC):
    """(key, cell dict) pairs for the sweep document, one per latency."""
    for mem_latency in mem_latencies:
        metrics, counters = run_mmu_cell(seed, mem_latency, spec)
        yield spec.cell_key(mem_latency), {
            "kind": "mmu",
            "workload": "paged_seq",
            "mem_latency": mem_latency,
            "transfer_bytes": spec.transfer_bytes,
            "metrics": metrics,
            "counters": counters,
        }
