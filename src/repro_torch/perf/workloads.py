"""Deterministic, seeded workload generators for the perf sweep.

Every generator maps an architecture's :class:`repro_torch.configs.base.ModelConfig`
to descriptor-chain traffic whose *shape* tracks that model: KV-page size
follows the head dimension, MoE dispatch fan-out follows the expert count
and top-k, token rows follow ``d_model``. The four families cover the
irregular-transfer space of the paper (§II-B) plus the serve-path patterns
the runtime was built for:

* ``paged_kv``     — serving bursts gathering mostly-sequential KV page runs
                     with fragmentation gaps (the allocator's sequential
                     preference; high coalesce + high §II-C hit rate);
* ``moe_dispatch`` — dispatch storms scattering token rows into per-expert
                     buffers in random arrival order (low coalesce, low hit
                     rate: the adversarial stream);
* ``chain_mix``    — one sequential, one strided, one random-permuted chain
                     per burst (the Fig-4 style microscopic patterns);
* ``defrag_churn`` — allocator churn: a partially-freed page map compacted
                     toward the front (mid coalesce, sequential layout).

Determinism contract: ``generate(name, cfg, scale, seed)`` is a pure
function of its arguments — the RNG is seeded from ``(seed, arch, name)``
only, so BENCH_perf.json baselines regenerate bit-for-bit.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.descriptor import DescriptorArray

ELEM_BYTES = 4     # pools are float32
_BUS_BYTES = 8     # simulator bus width; transfer_bytes must be a multiple


@dataclasses.dataclass(frozen=True)
class Scale:
    """Sweep sizing knobs (quick = CI, full = local baselines)."""

    name: str
    n_bursts: int        # chains submitted per workload
    burst_len: int       # descriptors per burst, pre-coalesce
    pool_elems: int      # src/dst pool size in elements
    max_len: int         # serial-tier max burst (elements)
    ring_capacity: int   # per-channel submission-ring slots
    sim_transfers: int   # per-channel transfers in the cycle model


# max_len (the serial engine's static burst window) sits well above the
# page size so coalesced page runs survive the split pass — a 64-elem
# window would cut merged runs straight back into page-sized pieces and
# hide the merge ratio the gate watches.
QUICK = Scale("quick", n_bursts=2, burst_len=96, pool_elems=1 << 14,
              max_len=512, ring_capacity=256, sim_transfers=200)
FULL = Scale("full", n_bursts=4, burst_len=192, pool_elems=1 << 15,
             max_len=512, ring_capacity=512, sim_transfers=400)

SCALES: Dict[str, Scale] = {"quick": QUICK, "full": FULL}


@dataclasses.dataclass
class Workload:
    name: str
    arch: str
    chains: List[DescriptorArray]
    pool_elems: int
    transfer_bytes: int       # representative payload size for the cycle model
    meta: Dict[str, float]


def _rng(seed: int, arch: str, name: str) -> np.random.Generator:
    mix = zlib.crc32(f"{arch}/{name}".encode())
    return np.random.default_rng([seed, mix])


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(v)))


@dataclasses.dataclass(frozen=True)
class ArchParams:
    """What each generator reads out of a ModelConfig."""

    page_elems: int    # KV page size (elements) ~ head dim
    kv_run: int        # typical sequential page-run length ~ kv heads
    experts: int       # MoE fan-out (surrogate for non-MoE archs)
    topk: int
    token_row: int     # dispatch row size (elements) ~ d_model


def arch_params(cfg: ModelConfig) -> ArchParams:
    return ArchParams(
        page_elems=_clamp(cfg.head_dim_, 8, 64),
        kv_run=_clamp(cfg.num_kv_heads, 2, 16),
        experts=_clamp(cfg.moe.num_experts if cfg.moe else cfg.num_heads,
                       4, 64),
        topk=_clamp(cfg.moe.experts_per_token if cfg.moe else 2, 1, 8),
        token_row=_clamp(cfg.d_model // 128, 4, 32),
    )


def _transfer_bytes(mean_elems: float) -> int:
    b = int(mean_elems * ELEM_BYTES)
    return max(_BUS_BYTES, (b // _BUS_BYTES) * _BUS_BYTES)


def _permuted_chain(src: np.ndarray, dst: np.ndarray, ln: np.ndarray,
                    perm: np.ndarray) -> DescriptorArray:
    """Store a logical (src, dst, ln) sequence at permuted table slots.

    ``perm[i]`` is the storage slot of visit step ``i`` (``perm[0]`` must be
    0: the runtime walks from head slot 0). A shuffled ``perm`` models a
    driver whose descriptor table was written out of walk order, which is
    exactly what defeats the §II-C sequential prefetcher.
    """
    n = len(perm)
    if n == 0 or perm[0] != 0:
        raise ValueError("perm[0] must be 0 (chain head is slot 0)")
    s = np.empty(n, np.int64)
    t = np.empty(n, np.int64)
    ell = np.empty(n, np.int64)
    nxt = np.empty(n, np.int64)
    s[perm] = src
    t[perm] = dst
    ell[perm] = ln
    nxt[perm[:-1]] = perm[1:]
    nxt[perm[-1]] = -1
    return DescriptorArray.create(s, t, ell, nxt=nxt)


def _shuffled_perm(rng: np.random.Generator, n: int) -> np.ndarray:
    perm = np.concatenate([[0], 1 + rng.permutation(n - 1)]) if n > 1 \
        else np.zeros(1, np.int64)
    return perm.astype(np.int64)


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def _paged_kv(cfg: ModelConfig, scale: Scale,
              rng: np.random.Generator) -> Tuple[List[DescriptorArray], int]:
    p = arch_params(cfg)
    n_pages_pool = scale.pool_elems // p.page_elems
    chains = []
    for _ in range(scale.n_bursts):
        page_ids: List[int] = []
        nxt_id = int(rng.integers(0, 8))
        while len(page_ids) < scale.burst_len:
            run = int(rng.integers(max(1, p.kv_run // 2), 2 * p.kv_run))
            page_ids.extend(range(nxt_id, nxt_id + run))
            nxt_id += run + int(rng.integers(1, 4))   # fragmentation gap
        ids = np.asarray(page_ids[:scale.burst_len], np.int64) % n_pages_pool
        src = ids * p.page_elems
        dst = np.arange(scale.burst_len, dtype=np.int64) * p.page_elems
        ln = np.full(scale.burst_len, p.page_elems, np.int64)
        chains.append(DescriptorArray.create(src, dst, ln))
    return chains, _transfer_bytes(p.page_elems)


def _moe_dispatch(cfg: ModelConfig, scale: Scale,
                  rng: np.random.Generator) -> Tuple[List[DescriptorArray], int]:
    p = arch_params(cfg)
    tokens = max(8, scale.burst_len // p.topk)
    expert_cap = scale.pool_elems // p.experts // p.token_row
    chains = []
    for _ in range(scale.n_bursts):
        fill = np.zeros(p.experts, np.int64)
        src = np.empty(tokens * p.topk, np.int64)
        dst = np.empty(tokens * p.topk, np.int64)
        for i in range(tokens):
            picks = rng.choice(p.experts, size=p.topk, replace=False)
            for j, e in enumerate(picks):
                k = i * p.topk + j
                src[k] = (i % (scale.pool_elems // p.token_row)) * p.token_row
                slot = fill[e] % max(expert_cap, 1)
                fill[e] += 1
                dst[k] = (e * expert_cap + slot) * p.token_row
        ln = np.full(len(src), p.token_row, np.int64)
        # Dispatch arrival order is routing order, not table order: the
        # descriptor table fills out of walk order (storm = low hit rate).
        perm = _shuffled_perm(rng, len(src))
        chains.append(_permuted_chain(src, dst, ln, perm))
    return chains, _transfer_bytes(p.token_row)


def _chain_mix(cfg: ModelConfig, scale: Scale,
               rng: np.random.Generator) -> Tuple[List[DescriptorArray], int]:
    p = arch_params(cfg)
    n = max(6, scale.burst_len // 3)
    seg = p.page_elems // 2 or 4
    limit = scale.pool_elems - 2 * n * seg
    chains = []
    for _ in range(scale.n_bursts):
        base_s = int(rng.integers(0, max(limit, 1)))
        base_d = int(rng.integers(0, max(limit, 1)))
        idx = np.arange(n, dtype=np.int64)
        # sequential: src and dst runs abut -> merges into max_len bursts
        chains.append(DescriptorArray.create(
            base_s + idx * seg, base_d + idx * seg,
            np.full(n, seg, np.int64)))
        # strided: 2-D row walk, no abutting ranges, sequential table
        chains.append(DescriptorArray.create(
            (idx * 2 * seg) % limit, (base_d + idx * 2 * seg) % limit,
            np.full(n, seg, np.int64)))
        # random: scattered ranges stored in shuffled table order
        src = rng.integers(0, scale.pool_elems - seg, n)
        dst = rng.integers(0, scale.pool_elems - seg, n)
        chains.append(_permuted_chain(
            src.astype(np.int64), dst.astype(np.int64),
            np.full(n, seg, np.int64), _shuffled_perm(rng, n)))
    return chains, _transfer_bytes(seg)


def _defrag_churn(cfg: ModelConfig, scale: Scale,
                  rng: np.random.Generator) -> Tuple[List[DescriptorArray], int]:
    p = arch_params(cfg)
    n_pages_pool = scale.pool_elems // p.page_elems
    n = min(scale.burst_len, n_pages_pool)
    chains = []
    for _ in range(scale.n_bursts):
        # Occupancy map after churn: ~30 % of pages freed, rest live.
        live = np.flatnonzero(rng.random(n_pages_pool) > 0.3)[:n]
        if len(live) == 0:
            live = np.asarray([0])
        src = live.astype(np.int64) * p.page_elems
        dst = np.arange(len(live), dtype=np.int64) * p.page_elems
        ln = np.full(len(live), p.page_elems, np.int64)
        chains.append(DescriptorArray.create(src, dst, ln))
    return chains, _transfer_bytes(p.page_elems)


def zipf_page_traffic(num_pages: int, n_touches: int, *,
                      alpha: float = 1.1,
                      rng: np.random.Generator,
                      hot_pages: np.ndarray = None) -> np.ndarray:
    """Bounded rank-based Zipf page-reference stream.

    Rank ``r`` (1-based) is touched with probability proportional to
    ``r ** -alpha``; ranks map onto page ids through ``hot_pages`` when
    given (rank 1 == ``hot_pages[0]``) or through a seeded permutation of
    the page space otherwise.  Unlike ``numpy``'s unbounded Zipf sampler
    every draw is a valid page id, so the stream can drive the sharded
    migration cells directly.  Pure function of ``(args, rng state)``.
    """
    if num_pages < 1:
        raise ValueError("num_pages must be >= 1")
    if alpha <= 0:
        raise ValueError("alpha must be > 0")
    weights = 1.0 / np.arange(1, num_pages + 1, dtype=np.float64) ** alpha
    weights /= weights.sum()
    page_of_rank = (np.asarray(hot_pages, np.int64) if hot_pages is not None
                    else rng.permutation(num_pages).astype(np.int64))
    if len(page_of_rank) != num_pages:
        raise ValueError("hot_pages must cover the whole page space")
    ranks = rng.choice(num_pages, size=n_touches, p=weights)
    return page_of_rank[ranks]


_GENERATORS = {
    "paged_kv": _paged_kv,
    "moe_dispatch": _moe_dispatch,
    "chain_mix": _chain_mix,
    "defrag_churn": _defrag_churn,
}

WORKLOAD_NAMES: Tuple[str, ...] = tuple(sorted(_GENERATORS))


def generate(name: str, cfg: ModelConfig, scale: Scale,
             seed: int) -> Workload:
    """Build one deterministic workload for (arch config, scale, seed)."""
    if name not in _GENERATORS:
        raise KeyError(f"unknown workload {name!r}; have {WORKLOAD_NAMES}")
    rng = _rng(seed, cfg.name, name)
    chains, transfer_bytes = _GENERATORS[name](cfg, scale, rng)
    n_desc = sum(c.num_descriptors for c in chains)
    mean_len = float(np.mean(np.concatenate(
        [np.asarray(c.length) for c in chains]))) if n_desc else 0.0
    return Workload(
        name=name, arch=cfg.name, chains=chains,
        pool_elems=scale.pool_elems, transfer_bytes=transfer_bytes,
        meta={"descriptors": n_desc, "mean_length_elems": mean_len},
    )
