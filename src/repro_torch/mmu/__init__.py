"""Virtual page addressing (DESIGN.md §11): the page table.

:class:`PageTable` maps virtual page ids to (shard, physical slot) with
per-page generation counters, the substrate for remap-based
defragmentation. :func:`repro_torch.runtime.lowering.translate_chain`
lowers a virtual page chain onto its physical slots through it. The IOTLB
cycle model is not ported yet.
"""
from .page_table import PageTable

__all__ = ["PageTable"]
