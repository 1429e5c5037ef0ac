"""IOTLB model: the DMA engine's translation cache (cycle simulator side).

Kurth et al. (arXiv 1808.09751) put an IOTLB in front of the DMA engine
and prefetch translations *along the descriptor chain* — the same
sequential-lookahead idea as the §II-C descriptor speculator, applied to
page walks. The model here mirrors that coupling: translation prefetches
ride the speculative descriptor fetch stream, and the lookahead depth is
a :mod:`repro_torch.core.speculation` policy (``FixedDepth`` /
``AdaptiveDepth``), so the TLB prefetcher and the descriptor speculator
share one policy vocabulary.

Timing model:

* a **walk** costs ``walk_cycles`` (default: one memory round trip,
  ``2L + PIPE``) on a dedicated walker port — walks overlap payload
  traffic, only *waiting* for one stalls the launch;
* an **access** to a cached, ready entry is free; to an in-flight
  prefetched entry it stalls until the walk lands (counted a hit — the
  prefetch already hid most of the walk); to an absent entry it stalls
  the full walk (a miss);
* capacity is LRU over ``entries`` translations.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

from repro_torch.core.speculation import DEFAULT_DEPTH, FixedDepth, PolicyLike

#: Fallback walk latency when the memory round trip is unknown (the
#: simulator derives ``2L + PIPE`` from its memory config instead).
DEFAULT_WALK_CYCLES = 20

#: Hardware-typical first-level IOTLB capacity (entries).
DEFAULT_ENTRIES = 32


@dataclasses.dataclass(frozen=True)
class IOTLBParams:
    """Engine-side IOTLB configuration (frozen: embeddable in SimConfig).

    ``walk_cycles = 0`` means "derive from the memory system": one
    request round trip, ``2 * mem_latency + PIPE``. ``prefetch`` is the
    chain-lookahead policy — ``FixedDepth(0)`` disables translation
    prefetching (every new page is a demand walk), the A/B leg the
    ``--no-iotlb``-adjacent cells measure against.
    """

    entries: int = DEFAULT_ENTRIES
    walk_cycles: int = 0
    prefetch: PolicyLike = FixedDepth(DEFAULT_DEPTH)

    def __post_init__(self):
        if self.entries < 1:
            raise ValueError("IOTLB needs >= 1 entry")
        if self.walk_cycles < 0:
            raise ValueError("walk_cycles must be >= 0")

    def resolved_walk_cycles(self, mem_latency: int) -> int:
        from repro_torch.core.simulator import PIPE
        return self.walk_cycles or (2 * int(mem_latency) + PIPE)


class IOTLB:
    """LRU translation cache with in-flight prefetch tracking."""

    def __init__(self, params: IOTLBParams, *, mem_latency: int = 13):
        self.params = params
        self.walk_cycles = params.resolved_walk_cycles(mem_latency)
        # vpage -> cycle the translation becomes usable (walk completion).
        self._entries: "OrderedDict[int, float]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.prefetches = 0
        self.walk_stall_cycles = 0.0

    def _insert(self, vpage: int, ready: float) -> None:
        self._entries[vpage] = ready
        self._entries.move_to_end(vpage)
        while len(self._entries) > self.params.entries:
            self._entries.popitem(last=False)

    def prefetch(self, vpage: int, now: float) -> None:
        """Start a walk for ``vpage`` if untranslated (walker port: free
        of bus contention; only *waiting* on it costs cycles)."""
        v = int(vpage)
        if v in self._entries:
            return
        self.prefetches += 1
        self._insert(v, now + self.walk_cycles)

    def access(self, vpage: int, now: float) -> float:
        """Translate at cycle ``now``; returns the stall in cycles."""
        v = int(vpage)
        ready = self._entries.get(v)
        if ready is not None:
            self._entries.move_to_end(v)
            self.hits += 1
            stall = max(0.0, ready - now)       # in-flight prefetch
        else:
            self.misses += 1
            stall = float(self.walk_cycles)     # demand walk
            self._insert(v, now + stall)
        self.walk_stall_cycles += stall
        return stall

    def invalidate(self, vpage: int) -> None:
        """Shootdown after a remap (cost modeled by
        :func:`repro_torch.mmu.page_table.remap_cycles`)."""
        self._entries.pop(int(vpage), None)

    @property
    def accesses(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.accesses
        return self.hits / n if n else 0.0

    def stats(self) -> dict:
        return {
            "entries": self.params.entries,
            "walk_cycles": self.walk_cycles,
            "hits": self.hits,
            "misses": self.misses,
            "prefetches": self.prefetches,
            "hit_rate": self.hit_rate,
            "walk_stall_cycles": float(self.walk_stall_cycles),
        }
