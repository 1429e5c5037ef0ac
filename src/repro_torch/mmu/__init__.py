"""MMU-aware virtual page addressing (DESIGN.md §11).

Mirrors Kurth et al. (arXiv 1808.09751): a DMA engine that walks page
tables and prefetches IOTLB entries along descriptor chains makes
virtual addressing essentially free for irregular transfer shapes. The
subsystem has two halves:

* :class:`PageTable` — virtual page id -> (shard, physical slot) with
  per-page generation counters, the substrate for remap-based
  defragmentation; :func:`repro_torch.runtime.lowering.translate_chain`
  lowers a virtual page chain onto its physical slots through it;
* :class:`IOTLB` / :class:`IOTLBParams` — the cycle-simulator model of
  the engine-side translation cache: walk latency, miss stalls, and
  prefetch-along-chain lookahead whose depth comes from the
  :mod:`repro_torch.core.speculation` policy layer.
"""
from .page_table import PageTable, TLB_SHOOTDOWN_CYCLES, remap_cycles
from .iotlb import IOTLB, IOTLBParams, DEFAULT_WALK_CYCLES

__all__ = [
    "PageTable",
    "IOTLB",
    "IOTLBParams",
    "DEFAULT_WALK_CYCLES",
    "TLB_SHOOTDOWN_CYCLES",
    "remap_cycles",
]
