"""Virtual page table: vpage -> (shard, physical slot) + generations.

The table is the single source of truth for where a virtual page's
contents live. Two invariants every mutator preserves (the hypothesis
suite in ``tests/test_mmu.py`` checks them):

* a remap never changes *which* contents a live vpage names — only the
  physical slot they occupy;
* every remap bumps both the per-page generation and the global
  generation, monotonically. A cached translation keyed on the global
  generation is therefore invalidated by *any* remap, and one keyed on a
  page generation by remaps of *that* page.

Cost model: a remap is a table write plus an IOTLB shootdown for the
stale entry — :func:`remap_cycles` is what the remap-vs-copy defrag
cell charges per page, against a full descriptor-chain copy.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

#: Cycles to invalidate one stale IOTLB entry after a remap (the engine
#: re-walks on next touch; the walk itself is charged by the IOTLB
#: model). Small by construction — the whole point of remap-defrag.
TLB_SHOOTDOWN_CYCLES = 2


def remap_cycles(n_pages: int, walk_cycles: int) -> int:
    """Modeled cost of remapping ``n_pages``: one table write + shootdown
    per page, plus one refill walk on the first post-remap touch."""
    if n_pages <= 0:
        return 0
    return n_pages * (1 + TLB_SHOOTDOWN_CYCLES) + walk_cycles


class PageTable:
    """Dense vpage -> (shard, slot) map with generation counters.

    Identity-initialized: vpage ``v`` starts mapped to slot ``v`` on the
    shard that physically owns slot ``v`` (``slot // pages_per_shard``
    for the sharded pool, shard 0 for single-node pools). ``slot == -1``
    marks a *pending* page: ownership has been flipped but contents not
    yet pulled (the lazy-migration state; ``home_of`` remembers where
    the bits still live).
    """

    def __init__(self, num_pages: int, num_shards: int = 1):
        if num_pages < 1 or num_shards < 1:
            raise ValueError("need >= 1 page and >= 1 shard")
        if num_pages % num_shards:
            raise ValueError("num_pages must divide evenly across shards")
        self.num_pages = int(num_pages)
        self.num_shards = int(num_shards)
        self.pages_per_shard = self.num_pages // self.num_shards
        self._slot = np.arange(self.num_pages, dtype=np.int64)
        self._shard = self._slot // self.pages_per_shard
        self._gen = np.zeros(self.num_pages, np.int64)
        # Pending (ownership-flipped, not yet pulled) pages: vpage ->
        # (home_shard, home_slot) where the contents still live.
        self._home: Dict[int, Tuple[int, int]] = {}
        self.generation = 0          # global: bumped by every mutation
        self.remaps = 0              # lifetime remap count (cost model)

    # -- lookups -------------------------------------------------------------
    def _check(self, vpage: int) -> int:
        v = int(vpage)
        if not 0 <= v < self.num_pages:
            raise IndexError(f"vpage {v} out of range [0, {self.num_pages})")
        return v

    def map(self, vpage: int) -> Tuple[int, int]:
        """(shard, physical slot); slot is -1 for a pending page."""
        v = self._check(vpage)
        return int(self._shard[v]), int(self._slot[v])

    def shard_of(self, vpage: int) -> int:
        return int(self._shard[self._check(vpage)])

    def slot_of(self, vpage: int) -> int:
        return int(self._slot[self._check(vpage)])

    def page_generation(self, vpage: int) -> int:
        return int(self._gen[self._check(vpage)])

    def is_pending(self, vpage: int) -> bool:
        return int(self._slot[self._check(vpage)]) < 0

    def home_of(self, vpage: int) -> Tuple[int, int]:
        """Where a pending page's contents still live (the pull source)."""
        v = self._check(vpage)
        if not self.is_pending(v):
            return self.map(v)
        return self._home[v]

    def slots_of(self, vpages: Sequence[int]) -> np.ndarray:
        """Vectorized translation (kernel-facing block tables). Entries
        < 0 pass through (the block tables' empty-slot sentinel)."""
        vp = np.asarray(vpages, np.int64)
        out = np.where(vp >= 0, self._slot[np.clip(vp, 0, None)], vp)
        return out.astype(np.int64)

    # -- mutations -----------------------------------------------------------
    def _bump(self, vpage: int) -> None:
        self._gen[vpage] += 1
        self.generation += 1

    def remap(self, vpage: int, shard: int, slot: int) -> None:
        """Point ``vpage`` at a (shard, slot); bumps generations."""
        v = self._check(vpage)
        if not 0 <= int(shard) < self.num_shards:
            raise IndexError(f"shard {shard} out of range")
        if int(slot) >= self.num_pages:
            raise IndexError(f"slot {slot} out of range")
        self._shard[v] = int(shard)
        self._slot[v] = int(slot)
        self._home.pop(v, None)
        self._bump(v)
        self.remaps += 1

    def remap_many(self, mapping: Dict[int, Tuple[int, int]]) -> None:
        """Atomic batch remap (sorted order, so replays are deterministic)."""
        for v in sorted(mapping):
            shard, slot = mapping[v]
            self.remap(v, shard, slot)

    def rehome_slots(self, slot_map: Dict[int, Tuple[int, int]]) -> None:
        """Physical relocation (evacuation/resize): every vpage whose
        slot appears in ``slot_map`` is remapped to its new (shard,
        slot) — so refs survive the move — and pending pages whose
        *pull home* moved follow too. Ascending-vpage order keeps
        replays deterministic."""
        if not slot_map:
            return
        keys = np.asarray(sorted(slot_map), np.int64)
        for v in np.flatnonzero(np.isin(self._slot, keys)):
            shard, slot = slot_map[int(self._slot[v])]
            self.remap(int(v), shard, slot)
        for v, (hs, hslot) in list(self._home.items()):
            if hslot in slot_map:
                self._home[v] = slot_map[hslot]

    def flip_owner(self, vpage: int, shard: int) -> None:
        """Ownership-first migration step 1: move the page's *owner* now,
        leave its contents where they are (pending state). The pull
        source is remembered so a first touch can fetch lazily."""
        v = self._check(vpage)
        if not 0 <= int(shard) < self.num_shards:
            raise IndexError(f"shard {shard} out of range")
        if not self.is_pending(v):
            self._home[v] = (int(self._shard[v]), int(self._slot[v]))
        self._shard[v] = int(shard)
        self._slot[v] = -1
        self._bump(v)

    def complete_pull(self, vpage: int, slot: int) -> Tuple[int, int]:
        """Ownership-first step 2 (first touch): contents have landed in
        ``slot`` on the owning shard. Returns the vacated home (shard,
        slot) for the caller to free."""
        v = self._check(vpage)
        if not self.is_pending(v):
            raise RuntimeError(f"vpage {v} is not pending a pull")
        home = self._home.pop(v)
        self._slot[v] = int(slot)
        self._bump(v)
        self.remaps += 1
        return home

    # -- oracle --------------------------------------------------------------
    def snapshot(self) -> Dict[str, np.ndarray]:
        """Copies of the raw arrays (the tests' numpy oracle)."""
        return {"shard": self._shard.copy(), "slot": self._slot.copy(),
                "gen": self._gen.copy()}

    def pending_pages(self) -> List[int]:
        return sorted(self._home)
