"""Chain-lowering JIT: a signature-keyed translation cache for dispatch.

The serve hot path submits structurally-identical descriptor chains step
after step (page reads against new bases, expert rows for new tokens).
Legacy dispatch re-plans each one with the Python coalescer and re-enters
the engine tiers. This module is the jace idiom applied to that path —
translate once per abstract structure, re-dispatch the cached artifact
cheaply:

* :meth:`TranslationCache.plan` canonicalizes the chain
  (:mod:`repro_torch.core.signature`), memoizes the *coalescer plan* on the
  chain's exact relative digest, and rebuilds the planned chain as pure
  vector ops — bit-identical to :func:`repro_torch.runtime.coalesce.coalesce`
  (same descriptors, same stats);
* :meth:`TranslationCache.lower` maps the plan's bucketed
  :class:`~repro_torch.core.signature.ChainSignature` to a
  :class:`LoweredChain` executor under an LRU bound, counting
  hit/miss/evict events into the attached
  :class:`~repro_torch.runtime.instrumentation.PerfProbe`;
* :class:`LoweredChain` executes a planned chain through one of three
  routes — an ordered per-descriptor copy for overlapping writes, a
  one-shot masked gather/scatter for disjoint chains, or the CUDA
  descriptor-copy / quantize-copy kernels for aligned uniform-unit chains
  and the fused ``blocked_2d`` drain. Operands are padded to the
  signature's pow2 buckets, as in the JAX package.

Kernel routes engage when the pools are CUDA tensors; on CPU pools they
decline exactly where the JAX package declines off the TPU, so the
translation counters of the two packages agree on the CPU.

The lowered executors write the destination pool **in place** (the JAX
package rebinds ``pools[name] = out``) and return it. Sources are read as
they were before the drain: a source that shares storage with the
destination is snapshotted first.

Correctness contract: a lowered drain must be bit-identical to the legacy
drain it replaces. ``LoweredChain.__call__`` therefore *declines* (returns
``None``) whenever the legacy engine's semantics could differ from the
oracle copy — the serial engine's fixed ``max_len`` window clamps near the
pool tail — or when pool dtypes mismatch; the caller then falls back to
the legacy path, trivially identical.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.trace import monotonic
from repro_torch.core.descriptor import (
    CONFIG_IRQ_ENABLE,
    DESCRIPTOR_BYTES,
    DescriptorArray,
)
from repro_torch.core.engine import scatter_drop
from repro_torch.core.prefetch import estimate_hit_rate
from repro_torch.core.signature import (
    CanonicalChain,
    ChainSignature,
    canonicalize,
    pow2_bucket,
    signature_of,
)
from repro_torch.core.transform import as_transform, kv8_roundtrip
from repro_torch.optim.compress import BLOCK

from .coalesce import CoalesceStats
from .instrumentation import PerfProbe

DEFAULT_ARTIFACT_ENTRIES = 64
DEFAULT_PLAN_ENTRIES = 256


# ---------------------------------------------------------------------------
# Fixed-shape executors (in place on ``dst``)
# ---------------------------------------------------------------------------

def _unaliased(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``src`` as it is now, safe to read while ``dst`` is written."""
    if src.untyped_storage().data_ptr() == dst.untyped_storage().data_ptr():
        return src.clone()
    return src


def _vector_copy(src_off, dst_off, ln, src, dst, *, width: int):
    """One-shot masked gather/scatter over a padded descriptor block.

    Safe for any offsets (clip + drop); padded entries carry ``ln < 0`` and
    write nothing. Requires disjoint dst ranges for chain-order
    equivalence — guaranteed by ``sig.overlap == False``.
    """
    offs = np.arange(width, dtype=np.int64)
    lnc = np.maximum(ln, 0)
    active = ln > 0
    sidx = np.clip(src_off[:, None] + offs[None, :], 0, src.shape[0] - 1)
    valid = (offs[None, :] < lnc[:, None]) & active[:, None]
    didx = np.where(valid, dst_off[:, None] + offs[None, :], dst.shape[0])
    rows = src[torch.from_numpy(sidx.reshape(-1)).to(src.device)]
    return scatter_drop(dst, didx.reshape(-1), rows,
                        valid=valid.reshape(-1))


def _serial_copy(src_off, dst_off, ln, src, dst, *, width: int):
    """Chain-order copy: descriptor k's writes land after k-1's.

    Reads come from ``src`` as it was before the drain throughout (the
    engines and the host oracle all snapshot the source pool first).
    """
    src = _unaliased(src, dst)
    offs = np.arange(width, dtype=np.int64)
    for k in range(src_off.shape[0]):
        if ln[k] <= 0:
            continue
        valid = offs < ln[k]
        sidx = np.clip(src_off[k] + offs, 0, src.shape[0] - 1)
        rows = src[torch.from_numpy(sidx).to(src.device)]
        scatter_drop(dst, dst_off[k] + offs, rows, valid=valid)
    return dst


# Transform-fused variants (DESIGN.md §9): the kv8 round trip of the source
# pool, or a zero target plus an add, around the same copies.

def _vector_copy_kv8(src_off, dst_off, ln, src, dst, *, width: int):
    return _vector_copy(src_off, dst_off, ln, kv8_roundtrip(src), dst,
                        width=width)


def _serial_copy_kv8(src_off, dst_off, ln, src, dst, *, width: int):
    return _serial_copy(src_off, dst_off, ln, kv8_roundtrip(src), dst,
                        width=width)


def _vector_copy_sum(src_off, dst_off, ln, src, dst, *, width: int):
    copied = _vector_copy(src_off, dst_off, ln, src, torch.zeros_like(dst),
                          width=width)
    return dst.add_(copied)


def _serial_copy_sum(src_off, dst_off, ln, src, dst, *, width: int):
    copied = _serial_copy(src_off, dst_off, ln, src, torch.zeros_like(dst),
                          width=width)
    return dst.add_(copied)


#: (mode, transform token) -> fused executor. Tokens outside this table
#: (transpose) have no lowered executor: the lowered path declines and
#: the channel's legacy transformed drain runs instead.
_EXEC = {
    ("vector", ""): _vector_copy,
    ("serial", ""): _serial_copy,
    ("vector", "kv8"): _vector_copy_kv8,
    ("serial", "kv8"): _serial_copy_kv8,
    ("vector", "sum"): _vector_copy_sum,
    ("serial", "sum"): _serial_copy_sum,
}

#: Tokens the lowered serial path can fuse.
FUSEABLE_TOKENS = ("", "kv8", "sum")


def _pad_block(so: np.ndarray, do: np.ndarray, ln: np.ndarray,
               n_pad: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad operands to the signature's descriptor bucket (ln == -1 idle)."""
    pad = n_pad - so.shape[0]
    if pad <= 0:
        return so, do, ln
    z = np.zeros(pad, so.dtype)
    return (np.concatenate([so, z]), np.concatenate([do, z]),
            np.concatenate([ln, np.full(pad, -1, ln.dtype)]))


class LoweredChain:
    """The lowered artifact for one signature bucket.

    Callable as ``lowered(descs, src, dst, max_len=...) -> dst' | None``;
    ``None`` means "not safe to substitute for the legacy engine here —
    run the legacy path". ``dispatches`` counts successful substitutions
    (one artifact, many dispatches, is the whole point).
    """

    def __init__(self, sig: ChainSignature):
        self.sig = sig
        if sig.tier == "blocked_2d":
            self.mode = "rows2d"
        elif sig.overlap:
            self.mode = "serial"
        else:
            self.mode = "vector"
        self.dispatches = 0

    # -- row-pool artifact (fused blocked_2d drain) --------------------------
    def _call_rows2d(self, d: DescriptorArray, src: torch.Tensor,
                     dst: torch.Tensor) -> Optional[torch.Tensor]:
        from repro_torch.kernels.descriptor_copy import (
            descriptor_copy_bucketed,
        )

        if self.sig.transform:
            return None   # fused 2-D batches are identity-only
        shape = dst.shape
        src2 = src.reshape(src.shape[0], -1)
        dst2 = dst.reshape(dst.shape[0], -1)
        if src2.shape[1] != dst2.shape[1] or src2.dtype != dst2.dtype:
            return None
        active = np.asarray(d.length) >= 0
        sidx = np.where(active, np.asarray(d.src, np.int64), -1)
        didx = np.where(active, np.asarray(d.dst, np.int64), -1)
        self.dispatches += 1
        out = descriptor_copy_bucketed(sidx, didx, src2, dst2,
                                       n_bucket=self.sig.n_class)
        return out.reshape(shape)

    # -- linear-pool artifacts (serial tier) ---------------------------------
    def __call__(self, d: DescriptorArray, src: torch.Tensor,
                 dst: torch.Tensor, *,
                 max_len: int = 0) -> Optional[torch.Tensor]:
        if self.mode == "rows2d":
            return self._call_rows2d(d, src, dst)
        n = d.num_descriptors
        if n > self.sig.n_class or src.ndim != 1 or dst.ndim != 1 \
                or src.dtype != dst.dtype:
            return None
        so = np.asarray(d.src, np.int64)
        do = np.asarray(d.dst, np.int64)
        ln = np.asarray(d.length, np.int64)
        if n and max_len > 0:
            # Legacy-fidelity guard: execute_serial copies through a fixed
            # max_len window that is clamped near the pool tail, diverging
            # from the oracle there. Decline rather than differ.
            if int(so.max()) + max_len > src.shape[0] \
                    or int(do.max()) + max_len > dst.shape[0]:
                return None
        so, do, ln = _pad_block(so, do, ln, self.sig.n_class)
        unit = self.sig.unit
        token = self.sig.transform
        if (self.mode == "vector" and unit > 0 and self.sig.aligned
                and token in ("", "kv8")
                and src.shape[0] % unit == 0 and dst.shape[0] % unit == 0
                and not np.any(so % unit) and not np.any(do % unit)):
            # The kv8 kernel route needs row-local 256-blocks to equal the
            # pool-absolute blocks of the transform contract: offsets are
            # unit-multiples and the pool is a unit-multiple long, so
            # unit % BLOCK == 0 makes the partitions coincide exactly.
            kv8_ok = (token == "kv8" and unit % BLOCK == 0
                      and src.dtype == torch.float32)
            if src.is_cuda and dst.is_cuda and (token == "" or kv8_ok):
                # Uniform aligned units on the card: whole-row moves through
                # the CUDA kernels over the unit-reshaped pools.
                sidx = np.where(ln == unit, so // unit, -1)
                didx = np.where(ln == unit, do // unit, -1)
                self.dispatches += 1
                if token == "kv8":
                    from repro_torch.kernels.quantize_copy import (
                        quantize_copy_bucketed,
                    )
                    out = quantize_copy_bucketed(
                        sidx, didx, src.reshape(-1, unit),
                        dst.reshape(-1, unit), n_bucket=self.sig.n_class)
                else:
                    from repro_torch.kernels.descriptor_copy import (
                        descriptor_copy_bucketed,
                    )
                    out = descriptor_copy_bucketed(
                        sidx, didx, src.reshape(-1, unit),
                        dst.reshape(-1, unit), n_bucket=self.sig.n_class)
                return out.reshape(dst.shape)
        fn = _EXEC.get((self.mode, token))
        if fn is None:
            return None
        self.dispatches += 1
        return fn(so, do, ln, src, dst, width=self.sig.unit_class)


# ---------------------------------------------------------------------------
# Vectorized coalescer plan (bit-identical to runtime.coalesce.coalesce)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Plan:
    """Memoized, base-address-relative coalescer output for one digest."""

    n_in: int
    n_out: int
    merged: int
    split: int
    in_hit: float
    out_hit: float
    rel_src: np.ndarray
    rel_dst: np.ndarray
    length: np.ndarray
    config: np.ndarray
    sig0: ChainSignature     # tier=""/depth=0 template; rebound per call


def _plan_relative(canon: CanonicalChain, max_len: int,
                   allow_merge: bool = True) -> _Plan:
    """Merge + split + sequential layout as vector passes.

    Element-wise contiguity against the predecessor is equivalent to the
    legacy loop's check against the accumulated run end: a run's end
    always equals its last member's end, so the transitive closure of the
    pairwise predicate reproduces the greedy loop exactly.
    ``allow_merge=False`` mirrors ``coalesce(..., allow_merge=False)``:
    every descriptor starts its own run (merge-unsafe transforms).
    """
    irq = int(CONFIG_IRQ_ENABLE)
    in_hit = estimate_hit_rate(canon.order * DESCRIPTOR_BYTES)
    act = canon.length > 0
    src, dst = canon.rel_src[act], canon.rel_dst[act]
    ln, cfg = canon.length[act], canon.config[act]
    n = int(ln.size)
    if n == 0:
        empty = np.zeros(0, np.int64)
        sig0 = signature_of(
            CanonicalChain(0, empty, empty, empty, empty, empty, 0, 0),
            tier="")
        return _Plan(canon.n_raw, 0, 0, 0, in_hit, 1.0,
                     empty, empty, empty, empty, sig0)

    if allow_merge:
        mergeable = ((src[1:] == src[:-1] + ln[:-1])
                     & (dst[1:] == dst[:-1] + ln[:-1])
                     & (cfg[1:] == cfg[:-1])
                     & ((cfg[:-1] & irq) == 0))
    else:
        mergeable = np.zeros(max(n - 1, 0), bool)
    brk = np.empty(n, bool)
    brk[0] = True
    brk[1:] = ~mergeable
    starts = np.flatnonzero(brk)
    run_len = np.add.reduceat(ln, starts)
    run_src, run_dst, run_cfg = src[starts], dst[starts], cfg[starts]

    pieces = -(-run_len // max_len)          # ceil-div, run_len > 0
    n_out = int(pieces.sum())
    rep = np.repeat(np.arange(starts.size), pieces)
    first = np.zeros(starts.size, np.int64)
    np.cumsum(pieces[:-1], out=first[1:])
    off = (np.arange(n_out, dtype=np.int64) - first[rep]) * max_len
    o_src = run_src[rep] + off
    o_dst = run_dst[rep] + off
    o_len = np.minimum(run_len[rep] - off, max_len)
    tail = off + o_len == run_len[rep]       # IRQ only once all bytes landed
    o_cfg = np.where(tail, run_cfg[rep], run_cfg[rep] & ~irq)

    sig0 = signature_of(
        CanonicalChain(n_out, np.arange(n_out, dtype=np.int64),
                       o_src - o_src[0], o_dst - o_dst[0],
                       o_len, o_cfg, 0, 0),
        tier="")
    return _Plan(
        n_in=canon.n_raw, n_out=n_out,
        merged=n - int(starts.size), split=n_out - int(starts.size),
        in_hit=in_hit,
        out_hit=estimate_hit_rate(
            np.arange(n_out, dtype=np.int64) * DESCRIPTOR_BYTES),
        rel_src=o_src, rel_dst=o_dst, length=o_len, config=o_cfg,
        sig0=sig0)


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanResult:
    """What :meth:`TranslationCache.plan` hands the scheduler."""

    planned: DescriptorArray
    stats: CoalesceStats
    signature: ChainSignature
    lowered: Optional[LoweredChain]
    digest: bytes


def disabled_stats() -> Dict[str, object]:
    """The counter block reported when translation is switched off."""
    return {"enabled": False, "hits": 0, "misses": 0, "evictions": 0,
            "size": 0, "capacity": 0, "lookups": 0, "hit_rate": 0.0,
            "plan_hits": 0, "plan_misses": 0,
            "transform_lookups": 0, "transform_fused": 0,
            "transform_fusion_hit_rate": 0.0}


def aggregate_stats(blocks) -> Dict[str, object]:
    """Sum per-shard translation-cache counter blocks (sharded serving).

    Inputs and output are *raw* bare-key blocks; the public surfaces wrap
    the result in the unified namespace (``repro_torch.obs.counters``).
    """
    out = disabled_stats()
    for b in blocks:
        out["enabled"] = out["enabled"] or bool(b.get("enabled"))
        for k in ("hits", "misses", "evictions", "size", "capacity",
                  "lookups", "plan_hits", "plan_misses",
                  "transform_lookups", "transform_fused"):
            out[k] += int(b.get(k, 0))
    out["hit_rate"] = out["hits"] / out["lookups"] if out["lookups"] else 0.0
    out["transform_fusion_hit_rate"] = (
        out["transform_fused"] / out["transform_lookups"]
        if out["transform_lookups"] else 0.0)
    return out


def translate_chain(d: DescriptorArray, table, row_elems: int,
                    *, translate_dst: bool = True) -> DescriptorArray:
    """Lower a *virtual* page chain onto physical slots (DESIGN.md §11).

    Each descriptor's src/dst offset is split into (vpage, in-page
    offset) at ``row_elems`` granularity and the vpage is rewritten to
    the owning :class:`repro_torch.mmu.PageTable` slot. Chain structure
    (order, lengths, config, links) is untouched, so the *virtual* chain's
    :class:`~repro_torch.core.signature.CanonicalChain` digest is stable
    across remaps. Pending (slot ``-1``) pages must be resolved by the
    pool before translation; they raise here rather than corrupt an
    address.
    """
    if row_elems < 1:
        raise ValueError("row_elems must be >= 1")

    def _xlate(off) -> np.ndarray:
        vp, rem = np.divmod(np.asarray(off, np.int64), row_elems)
        slots = table.slots_of(vp)
        if np.any(slots < 0):
            bad = sorted(np.asarray(vp)[slots < 0].tolist())
            raise RuntimeError(
                f"translate_chain: vpages {bad[:8]} are pending an "
                "ownership pull; resolve residency before lowering")
        return slots * row_elems + rem

    src = _xlate(d.src)
    dst = _xlate(d.dst) if translate_dst else np.asarray(d.dst, np.int64)
    return DescriptorArray.create(src, dst, np.asarray(d.length, np.int64),
                                  nxt=np.asarray(d.nxt, np.int64),
                                  config=np.asarray(d.config, np.int64))


class TranslationCache:
    """Signature-keyed artifact LRU + digest-keyed plan memo."""

    def __init__(self, max_entries: int = DEFAULT_ARTIFACT_ENTRIES,
                 plan_entries: int = DEFAULT_PLAN_ENTRIES):
        if max_entries < 1 or plan_entries < 1:
            raise ValueError("cache bounds must be >= 1")
        self.max_entries = max_entries
        self.plan_entries = plan_entries
        self._artifacts: "OrderedDict[ChainSignature, LoweredChain]" = \
            OrderedDict()
        self._plans: "OrderedDict[Tuple[bytes, int], _Plan]" = OrderedDict()
        self._seq: "OrderedDict[bytes, bool]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.plan_hits = 0
        self.plan_misses = 0
        self.transform_lookups = 0
        self.transform_fused = 0
        self.probe: Optional[PerfProbe] = None
        self.tracer = None          # repro_torch.obs.trace.Tracer, via attach_tracer
        self.track = "translation"

    # -- instrumentation -----------------------------------------------------
    def attach_probe(self, probe: Optional[PerfProbe]) -> None:
        self.probe = probe

    def attach_tracer(self, tracer) -> None:
        """Attach (or with None, detach) a lifecycle span tracer."""
        self.tracer = tracer

    def _event(self, event: str) -> None:
        if self.probe is not None:
            self.probe.on_translation(event)

    def stats(self) -> Dict[str, object]:
        lookups = self.hits + self.misses
        return {
            "enabled": True,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "size": len(self._artifacts),
            "capacity": self.max_entries,
            "lookups": lookups,
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "plan_hits": self.plan_hits,
            "plan_misses": self.plan_misses,
            "transform_lookups": self.transform_lookups,
            "transform_fused": self.transform_fused,
            "transform_fusion_hit_rate": (
                self.transform_fused / self.transform_lookups
                if self.transform_lookups else 0.0),
        }

    # -- plan memo -----------------------------------------------------------
    def plan(self, d: DescriptorArray, *, max_len: int, spec_depth: int = 0,
             tier: str = "serial", head: int = 0,
             transform=None) -> Optional[PlanResult]:
        """Coalesce ``d`` through the memo; None -> caller runs legacy.

        The returned planned chain and stats are bit-identical to
        ``coalesce(d, max_len=max_len, spec_depth=spec_depth,
        allow_merge=transform.merge_safe)``; malformed chains (cycles,
        bad links) decline so the legacy walker raises its canonical
        error. A non-identity ``transform`` joins the signature as its
        :attr:`~repro_torch.core.transform.TransformSpec.cache_token`, so the
        lowered artifact fuses the transform (DESIGN.md §9).
        """
        if max_len < 1 or spec_depth < 0:
            return None
        spec = as_transform(transform)
        token = spec.cache_token
        allow_merge = spec.merge_safe
        tr = self.tracer
        rec = tr is not None and tr.sampled(self.plan_hits
                                            + self.plan_misses)
        p0 = monotonic() if rec else 0.0
        canon = canonicalize(d, head)
        if canon is None:
            return None
        key = (canon.digest, int(max_len), allow_merge)
        plan = self._plans.get(key)
        plan_was_hit = plan is not None
        if plan is not None:
            self._plans.move_to_end(key)
            self.plan_hits += 1
            self._event("plan_hit")
        else:
            plan = _plan_relative(canon, max_len, allow_merge)
            self._plans[key] = plan
            self.plan_misses += 1
            self._event("plan_miss")
            while len(self._plans) > self.plan_entries:
                self._plans.popitem(last=False)

        if plan.n_out == 0:
            planned = DescriptorArray.create(
                np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
        else:
            planned = DescriptorArray.create(
                plan.rel_src + canon.src_base,
                plan.rel_dst + canon.dst_base,
                plan.length, config=plan.config)
        stats = CoalesceStats(
            n_in=plan.n_in, n_out=plan.n_out, merged=plan.merged,
            split=plan.split, input_hit_rate=plan.in_hit,
            output_hit_rate=plan.out_hit, provisioned_slack=spec_depth)
        sig = dataclasses.replace(
            plan.sig0, tier=tier,
            depth_class=pow2_bucket(spec_depth) if spec_depth else 0,
            transform=token)
        fuseable = token in FUSEABLE_TOKENS
        lowered = self.lower(sig) \
            if tier == "serial" and plan.n_out and fuseable else None
        if token:
            self.transform_lookups += 1
            self._event("transform_lookup")
            if lowered is not None:
                self.transform_fused += 1
                self._event("transform_fused")
        if rec:
            tr.complete("translate.plan", self.track, p0 * 1e6,
                        (monotonic() - p0) * 1e6,
                        result="plan_hit" if plan_was_hit else "plan_miss",
                        digest=canon.digest[:6].hex(),
                        n_out=plan.n_out)
        return PlanResult(planned, stats, sig, lowered, canon.digest)

    # -- artifact LRU --------------------------------------------------------
    def lower(self, sig: ChainSignature) -> LoweredChain:
        """Artifact for a signature: LRU get-or-build with counters."""
        tr = self.tracer
        rec = tr is not None and tr.sampled(self.hits + self.misses)
        art = self._artifacts.get(sig)
        if art is not None:
            self._artifacts.move_to_end(sig)
            self.hits += 1
            self._event("hit")
            if rec:
                tr.instant("translate.hit", self.track, tier=sig.tier)
            return art
        t0 = monotonic() if rec else 0.0
        art = LoweredChain(sig)
        self.misses += 1
        self._event("miss")
        if rec:
            tr.complete("translate.compile", self.track, t0 * 1e6,
                        (monotonic() - t0) * 1e6, tier=sig.tier)
        self._artifacts[sig] = art
        while len(self._artifacts) > self.max_entries:
            self._artifacts.popitem(last=False)
            self.evictions += 1
            self._event("evict")
        return art

    # -- fused blocked_2d route ---------------------------------------------
    def execute_rows_2d(self, d: DescriptorArray, src: torch.Tensor,
                        dst: torch.Tensor) -> Optional[torch.Tensor]:
        """Lowered drain for a fused row-move batch; None -> legacy path.

        Engages only for CUDA pools (the JAX package engages only on the
        TPU; on CPU pools both decline) and only when every active
        destination row is unique — duplicate rows rely on the legacy
        scatter's resolution order, which the kernel route must not
        silently change.
        """
        if not (src.is_cuda and dst.is_cuda) or src.ndim < 2 or dst.ndim < 2:
            return None
        if src.reshape(src.shape[0], -1).shape[1] \
                != dst.reshape(dst.shape[0], -1).shape[1] \
                or src.dtype != dst.dtype:
            return None
        ad = np.asarray(d.dst)[np.asarray(d.length) >= 0]
        if np.unique(ad).size != ad.size:
            return None
        sig = ChainSignature(
            tier="blocked_2d", n_class=pow2_bucket(d.num_descriptors),
            unit_class=1, layout="gather", unit=1, overlap=False,
            aligned=True, depth_class=0)
        return self.lower(sig)(d, src, dst)

    # -- memoized chain-shape predicates (scheduler satellites) --------------
    def is_sequential(self, d: DescriptorArray) -> bool:
        """Digest-memoized `nxt == [1..n-1, -1]` check."""
        key = np.asarray(d.nxt, np.int64).tobytes()
        hit = self._seq.get(key)
        if hit is not None:
            self._seq.move_to_end(key)
            return hit
        n = d.num_descriptors
        want = np.concatenate([np.arange(1, n), [-1]])
        res = bool(np.array_equal(np.asarray(d.nxt), want))
        self._seq[key] = res
        while len(self._seq) > self.plan_entries:
            self._seq.popitem(last=False)
        return res
