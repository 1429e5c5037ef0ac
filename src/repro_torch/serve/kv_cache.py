"""Paged KV cache: a page pool + per-sequence descriptor chains (§II-B as a
block table). One page = one descriptor: `src` = page id in the pool,
`next` links the sequence's pages, end-of-chain = -1. The allocator owns
placement, so chains are laid out sequentially when possible — making the
hardware's sequential speculation hit by construction (DESIGN.md §2).

Virtual addressing (DESIGN.md §11): sequence block tables hold *virtual*
page ids; a :class:`repro_torch.mmu.PageTable` maps them to physical pool
slots. ``defragment`` is therefore a *remap* — live pages get fresh
dense virtual ids pointing at their existing slots, so the §II-C
speculator sees a sequential chain without a single payload byte
crossing the bus. The legacy copy-defrag survives as ``mode="copy"``
(the A/B leg the remap-vs-copy perf cell measures against).

Page *moves* (migration, copy-defrag) are descriptor work and go
through the multi-channel DMA runtime (DESIGN.md §3): the pool registers
its page arrays as runtime pools and submits row-move chains instead of
calling execution engines directly.

The page pools are tensors on the cache's device (``cuda`` unless the
caller passes ``device="cpu"``); ``append`` writes them in place, and a
runtime drain may too. :meth:`PagedKVCache.from_numpy_state` rebuilds a
cache from host arrays (another cache's exported state).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chain import from_pages
from repro_torch.core.descriptor import DescriptorArray
from repro_torch.core.pageref import PageRef, as_pagerefs
from repro_torch.core.prefetch import estimate_hit_rate
from repro_torch.mmu import PageTable
from repro_torch.runtime import DMARuntime, SubmitRequest
from repro_torch.device import resolve_device


class OutOfPages(RuntimeError):
    pass


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array (bfloat16, which numpy lacks, as float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


@dataclasses.dataclass
class PageAllocator:
    """Free-list page allocator with sequential-preference placement.

    Allocates *virtual* page ids: the ids sequences hold in their block
    tables and the ids whose contiguity the §II-C speculator exploits.
    """

    num_pages: int

    def __post_init__(self):
        self._free = list(range(self.num_pages))
        self._owned: Dict[int, List[int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, seq_id: int, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise OutOfPages(f"need {n} pages, have {len(self._free)}")
        # Sequential preference: take the longest run of consecutive ids so
        # a hardware speculator prefetching page k+1 after page k would hit.
        self._free.sort()
        pages = self._free[:n]
        self._free = self._free[n:]
        self._owned.setdefault(seq_id, []).extend(pages)
        return pages

    def free(self, seq_id: int) -> None:
        self._free.extend(self._owned.pop(seq_id, []))

    def chain(self, seq_id: int, page_elems: int) -> DescriptorArray:
        """The sequence's block table as a descriptor chain (virtual)."""
        return from_pages(self._owned.get(seq_id, []), page_elems)

    def speculation_hit_rate(self, seq_id: int, page_bytes: int = 32) -> float:
        pages = self._owned.get(seq_id, [])
        addrs = np.asarray(pages, np.int64) * page_bytes
        return estimate_hit_rate(addrs) if len(pages) > 1 else 1.0


@dataclasses.dataclass
class PagedKVCache:
    """Single-layer paged pool, shared across sequences.

    k_pages/v_pages: (num_pages, page, KV, D) tensors on ``device``,
    indexed by *physical* slot. Block tables are dense (max_seqs,
    max_pages) int32 host snapshots of the descriptor chains in *virtual*
    ids; :meth:`kernel_args` translates them through the page table into
    the flattened physical form a paged-attention kernel consumes.
    """

    page: int
    num_pages: int
    max_seqs: int
    max_pages_per_seq: int
    kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.float32
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        shape = (self.num_pages, self.page, self.kv_heads, self.head_dim)
        self.k_pages = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.tables = np.full((self.max_seqs, self.max_pages_per_seq), -1,
                              np.int32)
        self.lengths = np.zeros((self.max_seqs,), np.int32)
        self.alloc = PageAllocator(self.num_pages)
        self.page_table = PageTable(self.num_pages)
        self._phys_free = list(range(self.num_pages))

    # -- translation ----------------------------------------------------------
    def _slot(self, vid: int) -> int:
        return self.page_table.slot_of(int(vid))

    def pageref(self, vid: int) -> PageRef:
        return PageRef(int(vid), self.page_table.page_generation(int(vid)))

    # -- sequence lifecycle ---------------------------------------------------
    def admit(self, slot: int) -> None:
        self.evict(slot)
        self.tables[slot] = -1
        self.lengths[slot] = 0

    def evict(self, slot: int) -> None:
        # Physical slots go back with their virtual ids: look them up
        # before the allocator forgets the ownership list.
        for v in self.alloc._owned.get(slot, []):
            self._phys_free.append(self._slot(v))
        self._phys_free.sort()
        self.alloc.free(slot)
        self.tables[slot] = -1
        self.lengths[slot] = 0

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, self.dtype)
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    def append(self, slot: int, k, v) -> None:
        """Append one token's KV (KV, D) to `slot`'s chain (in place)."""
        pos = int(self.lengths[slot])
        page_idx, offset = divmod(pos, self.page)
        if page_idx >= self.max_pages_per_seq:
            raise OutOfPages(f"sequence exceeds {self.max_pages_per_seq} pages")
        if self.tables[slot, page_idx] < 0:
            (page_id,) = self.alloc.alloc(slot, 1)
            phys = self._phys_free.pop(0)
            if self._slot(page_id) != phys:
                self.page_table.remap(page_id, 0, phys)
            self.tables[slot, page_idx] = page_id
        pid = self._slot(int(self.tables[slot, page_idx]))
        self.k_pages[pid, offset] = self._tensor(k)
        self.v_pages[pid, offset] = self._tensor(v)
        self.lengths[slot] = pos + 1

    # -- kernel-facing views ---------------------------------------------------
    def kernel_args(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
        phys = self.page_table.slots_of(
            self.tables.reshape(-1)).reshape(self.tables.shape)
        return (self.k_pages, self.v_pages,
                torch.from_numpy(phys.astype(np.int32)).to(self.device),
                torch.from_numpy(self.lengths.copy()).to(self.device))

    def chain(self, slot: int) -> DescriptorArray:
        """`slot`'s block table as a *virtual* descriptor chain — the
        layout the speculator sees; lower through
        :func:`repro_torch.runtime.lowering.translate_chain` to execute."""
        pages = [int(p) for p in self.tables[slot] if p >= 0]
        return from_pages(pages, self.page * self.kv_heads * self.head_dim)

    # -- runtime-mediated page moves (DESIGN.md §3) ---------------------------
    _POOL_K = "kv.k_pages"
    _POOL_V = "kv.v_pages"

    def register_with_runtime(self, rt: DMARuntime) -> None:
        """Expose the page arrays as runtime pools (idempotent refresh)."""
        rt.register_pool(self._POOL_K, self.k_pages)
        rt.register_pool(self._POOL_V, self.v_pages)

    def move_pages(self, rt: DMARuntime, src_pages: List[PageRef],
                   dst_pages: List[PageRef], *,
                   channel: Optional[str] = None) -> None:
        """Copy page *contents* between virtual pages through the runtime.

        Submits one row-move chain per pool (K and V) on a ``blocked_2d``
        channel — addressed physically via the page table — drains the
        runtime, and refreshes the local arrays from the runtime pools.
        """
        if len(src_pages) != len(dst_pages):
            raise ValueError("src/dst page lists must pair up")
        if not src_pages:
            return
        src_pages = as_pagerefs(src_pages, api="PagedKVCache.move_pages")
        dst_pages = as_pagerefs(dst_pages, api="PagedKVCache.move_pages")
        self._move_phys(rt, [self._slot(p) for p in src_pages],
                        [self._slot(p) for p in dst_pages], channel=channel)

    def _move_phys(self, rt: DMARuntime, src: List[int], dst: List[int],
                   *, channel: Optional[str] = None) -> None:
        self.register_with_runtime(rt)
        moves = DescriptorArray.create(
            np.asarray(src, np.int64),
            np.asarray(dst, np.int64),
            np.ones(len(src), np.int64))
        tier = None if channel else "blocked_2d"
        rt.submit(SubmitRequest(chain=moves, src_pool=self._POOL_K,
                                dst_pool=self._POOL_K, channel=channel,
                                tier=tier))
        rt.submit(SubmitRequest(chain=moves, src_pool=self._POOL_V,
                                dst_pool=self._POOL_V, channel=channel,
                                tier=tier))
        rt.drain_until_idle()
        self.k_pages = rt.pool(self._POOL_K)
        self.v_pages = rt.pool(self._POOL_V)

    def defragment(self, slot: int, rt: Optional[DMARuntime] = None, *,
                   channel: Optional[str] = None,
                   mode: str = "remap") -> float:
        """Compact `slot`'s pages onto the lowest-id free run and return the
        §II-C speculation hit rate of the new layout.

        ``mode="remap"`` (default): the live pages keep their physical
        slots; they are *renumbered* onto fresh dense virtual ids — a
        page-table update, no descriptor chain, no payload traffic.
        ``mode="copy"`` is the legacy physical compaction (descriptor
        work through the runtime, which it then requires). Both modes
        leave identical logical pool contents (the ``tests/test_mmu.py``
        oracle); a slot already on its best layout is left untouched.
        """
        if mode not in ("remap", "copy"):
            raise ValueError(f"mode must be 'remap' or 'copy', got {mode!r}")
        old = [int(p) for p in self.tables[slot] if p >= 0]
        n = len(old)
        if n == 0:
            return 1.0
        free = sorted(self.alloc._free)
        if len(free) < n:
            return self.alloc.speculation_hit_rate(slot)
        new = free[:n]
        new_rate = estimate_hit_rate(np.asarray(new, np.int64) * 32)
        cur_rate = self.alloc.speculation_hit_rate(slot)
        if new_rate <= cur_rate:
            return cur_rate
        if mode == "remap":
            # Renumber: new vid i -> old vid i's physical slot. Contents
            # never move; the old vids return to the virtual free pool.
            for nv, ov in zip(new, old):
                self.page_table.remap(nv, 0, self._slot(ov))
        else:
            if rt is None:
                raise ValueError("mode='copy' needs a runtime")
            # Legacy compaction: contents physically move onto the lowest
            # free slots, and the new vids map onto those slots.
            dst_phys = sorted(self._phys_free)[:n]
            self._move_phys(rt, [self._slot(ov) for ov in old], dst_phys,
                            channel=channel)
            for nv, ph in zip(new, dst_phys):
                if self._slot(nv) != ph:
                    self.page_table.remap(nv, 0, ph)
                self._phys_free.remove(ph)
            # The vacated source slots are free again.
            self._phys_free.extend(self._slot(ov) for ov in old)
            self._phys_free.sort()
        # Rewire bookkeeping: slot now owns `new`; `old` returns to the pool.
        self.alloc._free = [p for p in free if p not in set(new)] + old
        self.alloc._owned[slot] = list(new)
        self.tables[slot, :n] = np.asarray(new, np.int32)
        return new_rate

    def dense_view(self, slot: int) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize the logical (len, KV, D) cache (host-side oracle)."""
        ln = int(self.lengths[slot])
        ks, vs = [], []
        for i in range((ln + self.page - 1) // self.page):
            pid = self._slot(int(self.tables[slot, i]))
            ks.append(_host(self.k_pages[pid]))
            vs.append(_host(self.v_pages[pid]))
        if not ks:
            return (np.zeros((0, self.kv_heads, self.head_dim)),) * 2
        k = np.concatenate(ks)[:ln]
        v = np.concatenate(vs)[:ln]
        return k, v

    # -- state carry-over ------------------------------------------------------
    _STATE_SHAPE = ("page", "num_pages", "max_seqs", "max_pages_per_seq",
                    "kv_heads", "head_dim")

    @classmethod
    def from_numpy_state(cls, state: Dict[str, object], *, device=None,
                         dtype: Optional[torch.dtype] = None
                         ) -> "PagedKVCache":
        """A cache holding exactly the given host-side state.

        ``state`` holds plain numpy/Python values: the geometry
        (``page``, ``num_pages``, ``max_seqs``, ``max_pages_per_seq``,
        ``kv_heads``, ``head_dim``; each defaults to what the arrays
        imply), ``k_pages``, ``v_pages``, ``tables``, ``lengths``, the page
        table's ``slot`` map and ``gen`` generations (optionally ``shard``,
        ``generation`` and ``remaps``), and the allocator's ``free`` list
        and ``owned`` dict. ``phys_free`` (the free physical slots) is
        optional; without it the slots no owned page maps to are free.
        ``dtype`` defaults to the pages' dtype.
        """
        k = np.asarray(state["k_pages"])
        v = np.asarray(state["v_pages"])
        tables = np.asarray(state["tables"], np.int32)
        geom = dict(page=k.shape[1], num_pages=k.shape[0],
                    max_seqs=tables.shape[0],
                    max_pages_per_seq=tables.shape[1],
                    kv_heads=k.shape[2], head_dim=k.shape[3])
        geom.update({f: int(state[f]) for f in cls._STATE_SHAPE
                     if f in state})
        if dtype is None:
            dtype = torch.from_numpy(k[:0].copy()).dtype
        cache = cls(**geom, dtype=dtype, device=device)
        cache.k_pages = torch.from_numpy(k.copy()).to(cache.device, dtype)
        cache.v_pages = torch.from_numpy(v.copy()).to(cache.device, dtype)
        cache.tables = tables.copy()
        cache.lengths = np.asarray(state["lengths"], np.int32).copy()
        pt = cache.page_table
        pt._slot = np.asarray(state["slot"], np.int64).copy()
        pt._gen = np.asarray(state["gen"], np.int64).copy()
        if "shard" in state:
            pt._shard = np.asarray(state["shard"], np.int64).copy()
        pt.generation = int(state.get("generation", int(pt._gen.sum())))
        pt.remaps = int(state.get("remaps", 0))
        cache.alloc._free = [int(p) for p in state["free"]]
        cache.alloc._owned = {int(s): [int(p) for p in pages]
                              for s, pages in dict(state["owned"]).items()}
        if "phys_free" in state:
            cache._phys_free = [int(p) for p in state["phys_free"]]
        else:
            used = {pt.slot_of(p) for pages in cache.alloc._owned.values()
                    for p in pages}
            cache._phys_free = [p for p in range(cache.num_pages)
                                if p not in used]
        return cache

    def to_numpy_state(self) -> Dict[str, object]:
        """The inverse of :meth:`from_numpy_state` (host copies)."""
        snap = self.page_table.snapshot()
        return {
            "page": self.page, "num_pages": self.num_pages,
            "max_seqs": self.max_seqs,
            "max_pages_per_seq": self.max_pages_per_seq,
            "kv_heads": self.kv_heads, "head_dim": self.head_dim,
            "k_pages": _host(self.k_pages), "v_pages": _host(self.v_pages),
            "tables": self.tables.copy(), "lengths": self.lengths.copy(),
            "slot": snap["slot"], "gen": snap["gen"],
            "shard": snap["shard"],
            "generation": self.page_table.generation,
            "remaps": self.page_table.remaps,
            "free": list(self.alloc._free),
            "owned": {s: list(p) for s, p in self.alloc._owned.items()},
            "phys_free": list(self._phys_free),
        }
