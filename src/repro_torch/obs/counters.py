"""Unified perf-counter key namespace (DESIGN.md §9).

The four ``perf_counters()`` surfaces — ``ServeEngine``,
``ShardedServeEngine``, ``DMARuntime.translation_stats`` and
``PerfProbe`` — historically returned four ad-hoc dict layouts. They now
share one documented namespace:

* ``serve.*``        — serve-engine step/latency/admission counters
  (``serve.steps``, ``serve.completed``, ``serve.request_latency_steps_p50``,
  …);
* ``sharded.*``      — mesh-level counters (``sharded.num_shards``,
  ``sharded.requests_per_shard``, ``sharded.remote_page_reads``,
  ``sharded.migration``, ``sharded.per_shard``, plus the DESIGN.md §11
  virtual-paging block: ``sharded.first_touch_pulls``,
  ``sharded.page_table_generation``, ``sharded.page_table_remaps``,
  ``sharded.pending_pages``);
* ``translation.*``  — chain-lowering cache counters
  (``translation.hits``, ``translation.lookups``,
  ``translation.transform_fusion_hit_rate``, …), plus a nested
  ``translation`` block on the serve/sharded surfaces;
* ``channels.*``     — per-channel probe snapshots
  (``channels.<name>.<field>``).

:class:`PerfCounters` is a plain ``dict`` whose keys are the canonical
dotted ones. The bare-key DeprecationWarning aliases shipped for one
release after 0.4 and are now removed: reading an old bare key is a
plain ``KeyError``, exactly like any other missing key.

Internal producers (``TranslationCache.stats()``)
keep returning *raw* bare-key dicts; wrapping happens once, at each
public surface, via :func:`namespaced`.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional


class PerfCounters(dict):
    """Canonical-key counter dict (dotted unified namespace)."""

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        super().__init__(data or {})


def namespaced(raw: Mapping[str, Any], prefix: str, *,
               extra: Optional[Mapping[str, Any]] = None) -> PerfCounters:
    """Wrap a raw bare-key block as ``{prefix}.{key}`` canonical keys.

    ``extra`` entries are stored verbatim (already-canonical keys such
    as a nested ``translation`` block).
    """
    data = {f"{prefix}.{k}": v for k, v in raw.items()}
    if extra:
        data.update(extra)
    return PerfCounters(data)
