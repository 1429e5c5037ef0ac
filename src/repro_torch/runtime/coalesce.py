"""Pre-submission descriptor planner: merge, split, lay out sequentially.

The paper builds irregular transfers from chains of simple linear segments
(§II-B); the runtime's coalescer is the software pass that makes those
chains cheap to execute:

* **merge** — adjacent-in-chain descriptors whose source AND destination
  ranges abut are fused into one longer descriptor (fewer launches, closer
  to Eq. 1's ideal payload/descriptor ratio);
* **split** — any descriptor longer than the engine's ``max_len`` burst is
  cut into ``max_len``-sized pieces (the u32 length field / max-burst rule);
* **layout** — the output chain is laid out in walk order at sequential
  table addresses, so the §II-C speculative prefetcher's hit rate is 1.0 by
  construction; :func:`coalesce` reports both the pre-layout hit rate the
  input chain would have seen and the post-layout rate, via
  :func:`repro_torch.core.prefetch.estimate_hit_rate`.

Merging never crosses a descriptor with ``CONFIG_IRQ_ENABLE`` set (its
completion event is a per-descriptor contract) and only fuses descriptors
with identical config bits.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.chain import walk_chain_host
from repro_torch.core.descriptor import (
    DESCRIPTOR_BYTES,
    CONFIG_IRQ_ENABLE,
    DescriptorArray,
)
from repro_torch.core.prefetch import estimate_hit_rate


@dataclasses.dataclass(frozen=True)
class CoalesceStats:
    n_in: int
    n_out: int
    merged: int            # descriptors eliminated by fusion
    split: int             # descriptors added by max_len splitting
    input_hit_rate: float  # §II-C hit rate of the chain as submitted
    output_hit_rate: float # hit rate after sequential layout (1.0 by constr.)
    provisioned_slack: int = 0  # sequential-layout slack the speculation
                                # policy asked for at plan time (0 = legacy
                                # caller without a policy)

    @property
    def merge_ratio(self) -> float:
        """n_in / n_out — >1 means the planner shrank the stream."""
        return self.n_in / max(self.n_out, 1)


def _chain_order_fields(d: DescriptorArray, head: int):
    order = walk_chain_host(d, head)
    src = np.asarray(d.src, np.int64)[order]
    dst = np.asarray(d.dst, np.int64)[order]
    ln = np.asarray(d.length, np.int64)[order]
    cfg = np.asarray(d.config, np.int64)[order]
    return order, src, dst, ln, cfg


def input_hit_rate(d: DescriptorArray, head: int = 0,
                   table_base: int = 0) -> float:
    """Hit rate a sequential speculator sees on the chain *as submitted*,
    i.e. with descriptor k stored at slot k of a sequential table."""
    order = walk_chain_host(d, head)
    addrs = table_base + np.asarray(order, np.int64) * DESCRIPTOR_BYTES
    return estimate_hit_rate(addrs)


def coalesce(
    d: DescriptorArray,
    *,
    max_len: int,
    head: int = 0,
    spec_depth: int = 0,
    allow_merge: bool = True,
) -> Tuple[DescriptorArray, CoalesceStats]:
    """Plan a chain for submission: merge, split, sequential layout.

    Returns ``(planned, stats)`` where ``planned`` executes bit-identically
    to ``d`` under serial chain semantics (same bytes moved in the same
    order), holds no descriptor longer than ``max_len``, and is chained
    ``0 -> 1 -> ... -> n-1`` (sequential layout).

    ``spec_depth`` is the sequential-layout slack the caller's speculation
    policy asked for (DESIGN.md §5): the planner must guarantee a §II-C
    prefetcher with that many outstanding slots never fetches off a
    sequential run. The full walk-order layout satisfies any depth by
    construction, so the depth is recorded in
    :attr:`CoalesceStats.provisioned_slack` (the planner's side of the
    feedback contract) rather than changing the plan; it never alters the
    planned chain, keeping ``FixedDepth`` callers bit-identical to the
    pre-policy planner.

    ``allow_merge=False`` disables the merge pass (split and sequential
    layout still run). The runtime sets it from the submission's
    :attr:`repro_torch.core.transform.TransformSpec.merge_safe`: a transform
    whose source-view contiguity differs from pool contiguity (transpose)
    must execute its descriptors unfused.
    """
    if max_len < 1:
        raise ValueError("max_len must be >= 1")
    if spec_depth < 0:
        raise ValueError("spec_depth must be >= 0")
    n_in = d.num_descriptors
    order, src, dst, ln, cfg = _chain_order_fields(d, head)
    in_hit = estimate_hit_rate(
        np.asarray(order, np.int64) * DESCRIPTOR_BYTES)

    # -- merge pass (over chain order) -------------------------------------
    m_src: List[int] = []
    m_dst: List[int] = []
    m_len: List[int] = []
    m_cfg: List[int] = []
    merged = 0
    for k in range(len(order)):
        if ln[k] <= 0:
            continue   # completed / sentinel entries carry no payload
        if m_src:
            contiguous = (m_src[-1] + m_len[-1] == src[k]
                          and m_dst[-1] + m_len[-1] == dst[k])
            same_cfg = m_cfg[-1] == cfg[k]
            irq_barrier = bool(m_cfg[-1] & CONFIG_IRQ_ENABLE)
            if allow_merge and contiguous and same_cfg and not irq_barrier:
                m_len[-1] += int(ln[k])
                merged += 1
                continue
        m_src.append(int(src[k]))
        m_dst.append(int(dst[k]))
        m_len.append(int(ln[k]))
        m_cfg.append(int(cfg[k]))

    # -- split pass (max burst) --------------------------------------------
    o_src: List[int] = []
    o_dst: List[int] = []
    o_len: List[int] = []
    o_cfg: List[int] = []
    split = 0
    for s, t, l, c in zip(m_src, m_dst, m_len, m_cfg):
        off = 0
        first = True
        while l > 0:
            piece = min(l, max_len)
            o_src.append(s + off)
            o_dst.append(t + off)
            o_len.append(piece)
            # IRQ fires once per logical descriptor: keep it on the tail
            # piece only, so the event means "all bytes landed".
            if l > piece:
                o_cfg.append(c & ~int(CONFIG_IRQ_ENABLE))
            else:
                o_cfg.append(c)
            off += piece
            l -= piece
            if not first:
                split += 1
            first = False

    if not o_src:   # fully-sentinel input: keep a well-formed empty chain
        planned = DescriptorArray.create(
            np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64))
        stats = CoalesceStats(n_in, 0, merged, split, in_hit, 1.0,
                              provisioned_slack=spec_depth)
        return planned, stats

    # -- sequential layout: 0 -> 1 -> ... -> -1 (hits by construction) -----
    planned = DescriptorArray.create(
        np.asarray(o_src, np.int64),
        np.asarray(o_dst, np.int64),
        np.asarray(o_len, np.int64),
        config=np.asarray(o_cfg, np.int64),
    )
    out_addrs = np.arange(len(o_src), dtype=np.int64) * DESCRIPTOR_BYTES
    stats = CoalesceStats(
        n_in=n_in,
        n_out=len(o_src),
        merged=merged,
        split=split,
        input_hit_rate=in_hit,
        output_hit_rate=estimate_hit_rate(out_addrs),
        provisioned_slack=spec_depth,
    )
    return planned, stats
