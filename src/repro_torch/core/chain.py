"""Descriptor chains (§II-B) — builders, walkers, and the TPU-parallel flatten.

The paper constructs "arbitrary and irregular transfers from simple linear
transfers" by chaining descriptors through the ``next`` field. This module
provides:

* builders that express common irregular patterns (strided 2-D/3-D tiles,
  gather/scatter index lists, KV-cache page lists) as descriptor chains;
* a host-side walker (the faithful serial semantics);
* :func:`flatten_chain` — pointer-doubling list ranking in O(log N) tensor
  steps. The RTL frontend walks chains serially at ~1 descriptor / (2L+6)
  cycles; a vector machine parallelizes the walk instead (beyond-paper
  adaptation recorded in DESIGN.md §2);
* :func:`plan_sequential_layout` — the software speculation guarantee: the
  paper speculates that the *next* descriptor sits at the sequentially next
  address (§II-C). When we own allocation we can *make that true*, so the
  planner lays chains out contiguously and reports the hit rate a hardware
  prefetcher would see.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .descriptor import (
    DESCRIPTOR_BYTES,
    END_OF_CHAIN,
    DescriptorArray,
    pack,
)

# ---------------------------------------------------------------------------
# Builders (device SoA form)
# ---------------------------------------------------------------------------

def from_segments(src_offsets, dst_offsets, lengths) -> DescriptorArray:
    """One descriptor per (src, dst, length) linear segment, chained in order."""
    return DescriptorArray.create(src_offsets, dst_offsets, lengths)


def from_strided_2d(
    src_base: int,
    dst_base: int,
    row_len: int,
    num_rows: int,
    src_stride: int,
    dst_stride: int,
) -> DescriptorArray:
    """A 2-D tile copy as a chain of per-row linear descriptors (CubeDMA-style)."""
    rows = np.arange(num_rows, dtype=np.int64)
    return DescriptorArray.create(
        src_base + rows * src_stride,
        dst_base + rows * dst_stride,
        np.full(num_rows, row_len, np.int64),
    )


def from_strided_3d(
    src_base: int,
    dst_base: int,
    row_len: int,
    shape: Tuple[int, int],           # (planes, rows)
    src_strides: Tuple[int, int],     # (plane, row)
    dst_strides: Tuple[int, int],
) -> DescriptorArray:
    planes, rows = shape
    p = np.repeat(np.arange(planes, dtype=np.int64), rows)
    r = np.tile(np.arange(rows, dtype=np.int64), planes)
    return DescriptorArray.create(
        src_base + p * src_strides[0] + r * src_strides[1],
        dst_base + p * dst_strides[0] + r * dst_strides[1],
        np.full(planes * rows, row_len, np.int64),
    )


def from_gather(indices, unit: int, dst_base: int = 0) -> DescriptorArray:
    """Gather `unit`-element rows at `indices` into a contiguous destination."""
    idx = np.asarray(indices, np.int64)
    n = idx.shape[0]
    return DescriptorArray.create(
        idx * unit,
        dst_base + np.arange(n, dtype=np.int64) * unit,
        np.full(n, unit, np.int64),
    )


def from_scatter(indices, unit: int, src_base: int = 0) -> DescriptorArray:
    """Scatter contiguous `unit`-element rows out to `indices`."""
    idx = np.asarray(indices, np.int64)
    n = idx.shape[0]
    return DescriptorArray.create(
        src_base + np.arange(n, dtype=np.int64) * unit,
        idx * unit,
        np.full(n, unit, np.int64),
    )


def from_pages(page_ids, page_elems: int, dst_base: int = 0) -> DescriptorArray:
    """A KV-cache page list as a descriptor chain (one page = one descriptor).

    This is the serving-side embodiment of the paper's format: a sequence's
    block table is exactly a chain whose last entry carries end-of-chain.
    """
    return from_gather(page_ids, page_elems, dst_base)


def concat_chains(chains: Sequence[DescriptorArray]) -> DescriptorArray:
    """FIFO-chain multiple chains into one table (§II-E driver 'commit' step).

    Successor indices are rebased; each chain's end-of-chain is rewired to the
    next chain's head, except the last.
    """
    srcs, dsts, lens, nxts, cfgs = [], [], [], [], []
    base = 0
    for i, c in enumerate(chains):
        n = c.num_descriptors
        nxt = np.asarray(c.nxt, np.int64).copy()
        tail = nxt < 0
        nxt = nxt + base
        if i + 1 < len(chains):
            nxt[tail] = base + n  # assumes each chain is head-at-0 contiguous
        else:
            nxt[tail] = -1
        srcs.append(np.asarray(c.src)); dsts.append(np.asarray(c.dst))
        lens.append(np.asarray(c.length)); nxts.append(nxt)
        cfgs.append(np.asarray(c.config))
        base += n
    return DescriptorArray.create(
        np.concatenate(srcs), np.concatenate(dsts), np.concatenate(lens),
        np.concatenate(nxts), np.concatenate(cfgs))


# ---------------------------------------------------------------------------
# Walkers
# ---------------------------------------------------------------------------

def walk_chain_host(d: DescriptorArray, head: int = 0) -> List[int]:
    """Faithful serial chain walk (reference semantics; host only)."""
    nxt = np.asarray(d.nxt)
    order, cur, seen = [], head, set()
    while cur != -1:
        if cur in seen:
            raise ValueError(f"descriptor chain contains a cycle at index {cur}")
        seen.add(cur)
        order.append(cur)
        cur = int(nxt[cur])
    return order


def flatten_chain(nxt, head=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pointer-doubling list ranking: chain order in O(log N) vector steps.

    Args:
      nxt: int32[N] successor indices, -1 terminates (any device).
      head: index of the chain head.

    Returns:
      (perm, count): ``perm[k]`` = index of the k-th descriptor in chain
      order (entries past the chain length are -1), ``count`` = chain length
      (a 0-d int32 tensor). Nodes not reachable from ``head`` are excluded.
    """
    nxt = torch.as_tensor(nxt).to(torch.int64)
    n = nxt.shape[0]
    steps = max(1, math.ceil(math.log2(max(n, 2))))

    # Binary lifting: J[k][i] = 2^k-th successor of i (-1 past the end), and
    # dist[i] = #hops from i to end-of-chain via the same doubling.
    jumps = [nxt]
    dist = (nxt >= 0).to(torch.int64)
    j = nxt
    for _ in range(steps):
        has = j >= 0
        jc = j.clamp_min(0)
        dist = torch.where(has, dist + dist[jc], dist)
        j = torch.where(has, j[jc], j)
        jumps.append(j)

    count = dist[int(head)] + 1

    # perm[r] = the node r hops from head: apply jump tables by bits of r.
    r = torch.arange(n, dtype=torch.int64, device=nxt.device)
    cur = torch.full((n,), int(head), dtype=torch.int64, device=nxt.device)
    neg = torch.full_like(cur, -1)
    for k in range(steps + 1):
        take = ((r >> k) & 1) == 1
        has = cur >= 0
        stepped = torch.where(has, jumps[k][cur.clamp_min(0)], neg)
        cur = torch.where(take, stepped, cur)
    perm = torch.where(r < count, cur, neg)
    return perm.to(torch.int32), count.to(torch.int32)


# ---------------------------------------------------------------------------
# Speculative-layout planner (§II-C, software guarantee)
# ---------------------------------------------------------------------------

def plan_sequential_layout(
    d: DescriptorArray,
    table_base: int = 0x1000,
    head: int = 0,
) -> Tuple[np.ndarray, float]:
    """Assign byte addresses to descriptor slots so speculation hits.

    The hardware speculates address ``a + 32`` after fetching the descriptor
    at ``a``. Laying out the chain in walk order at consecutive addresses
    makes every speculation hit. Returns (packed_table_in_walk_order,
    predicted_hit_rate); the hit rate is 1.0 by construction unless the chain
    branches/was pre-placed (we recompute it honestly from the layout).
    """
    order = walk_chain_host(d, head)
    addr = {idx: table_base + k * DESCRIPTOR_BYTES for k, idx in enumerate(order)}
    nxt_np = np.asarray(d.nxt)
    next_addrs, hits = [], 0
    for k, idx in enumerate(order):
        nx = int(nxt_np[idx])
        na = END_OF_CHAIN if nx == -1 else np.uint64(addr[nx])
        next_addrs.append(na)
        if nx != -1 and addr[nx] == addr[idx] + DESCRIPTOR_BYTES:
            hits += 1
    denom = max(len(order) - 1, 1)
    hit_rate = hits / denom if len(order) > 1 else 1.0
    table = pack(
        np.asarray(d.length)[order],
        np.asarray(d.config)[order],
        next_addrs,
        np.asarray(d.src)[order],
        np.asarray(d.dst)[order],
    )
    return table, hit_rate


def measure_hit_rate(table: np.ndarray, head_addr: int, table_base: int) -> float:
    """Hit rate a sequential speculator would observe on a packed table."""
    n = len(table)
    if n <= 1:
        return 1.0
    addr_of = lambda i: table_base + i * DESCRIPTOR_BYTES
    index_of = {addr_of(i): i for i in range(n)}
    cur = index_of[head_addr]
    hits = total = 0
    while True:
        nxt = int(table["next"][cur])
        if np.uint64(nxt) == END_OF_CHAIN:
            break
        total += 1
        if nxt == addr_of(cur) + DESCRIPTOR_BYTES:
            hits += 1
        cur = index_of[nxt]
    return hits / max(total, 1)
