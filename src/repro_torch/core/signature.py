"""Chain canonicalization: base-address-invariant shape/stride signatures.

The translation cache (:mod:`repro_torch.runtime.lowering`) keys compiled
executors on the *abstract structure* of a descriptor chain, not its
concrete addresses — the jace idiom (trace once per abstract input
structure, re-dispatch the cached artifact cheaply) applied to §II-B
descriptor chains. This module computes that structure:

* :func:`walk_order` — the chain's walk permutation, vectorized with
  numpy binary lifting (no per-descriptor Python loop; the whole point of
  the cache is that steady-state submission does O(log n) vector work);
* :func:`canonicalize` — the chain's fields in walk order, re-based so
  ``src[first] == dst[first] == 0``. Two chains that differ only by a
  constant base shift canonicalize to equal relative forms;
* :class:`ChainSignature` — the bucketed cache key: segment-count bucket,
  unit-size class, sequential/strided/gather layout, overlap and
  alignment flags, speculation-depth class, engine tier. Signatures are
  deliberately coarser than canonical forms: every chain in a bucket
  dispatches through one compiled artifact (operands carry the exact
  offsets);
* :attr:`CanonicalChain.digest` — the *exact* relative-form fingerprint,
  used to memoize the coalescer plan (plan reuse needs exact-match, not
  bucket-match).

Everything here is pure numpy over host data; nothing touches torch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional

import numpy as np

from .descriptor import DescriptorArray

LAYOUT_SEQUENTIAL = "sequential"
LAYOUT_STRIDED = "strided"
LAYOUT_GATHER = "gather"


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (bucket id; 1 for n <= 1)."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def walk_order(nxt: np.ndarray, head: int = 0) -> Optional[np.ndarray]:
    """Chain walk permutation via numpy pointer doubling.

    Mirrors :func:`repro_torch.core.chain.flatten_chain` (same binary-lifting
    scheme) on the host, returning the ``count``-long order array, or
    ``None`` when the chain is malformed (cycle reachable from ``head``,
    out-of-range successor) — callers fall back to the legacy walker,
    which raises the canonical error.
    """
    nxt = np.asarray(nxt, np.int64)
    n = int(nxt.size)
    if n == 0:
        return np.zeros(0, np.int64)
    if not 0 <= head < n:
        return None
    if np.any(nxt >= n):
        return None
    # Sequential fast path: the shape every coalesced chain has.
    if head == 0 and nxt[-1] < 0 and np.array_equal(
            nxt[:-1], np.arange(1, n, dtype=np.int64)):
        return np.arange(n, dtype=np.int64)

    steps = max(1, math.ceil(math.log2(max(n, 2))))
    jumps = [nxt]
    dist = np.where(nxt >= 0, 1, 0).astype(np.int64)
    j = nxt
    for _ in range(steps):
        has = j >= 0
        jc = np.maximum(j, 0)
        dist = np.where(has, dist + dist[jc], dist)
        j = np.where(has, j[jc], j)
        jumps.append(j)

    count = int(dist[head]) + 1
    if count > n:
        return None   # a reachable cycle inflates the lifted distance

    r = np.arange(count, dtype=np.int64)
    cur = np.full(count, head, np.int64)
    for k in range(steps + 1):
        take = ((r >> k) & 1) == 1
        has = cur >= 0
        stepped = np.where(has, jumps[k][np.maximum(cur, 0)], -1)
        cur = np.where(take, stepped, cur)
    if np.any(cur < 0) or np.unique(cur).size != count:
        return None
    return cur


@dataclasses.dataclass(frozen=True)
class CanonicalChain:
    """A chain's fields in walk order, relative to its first segment."""

    n_raw: int                # descriptors in the submitted array
    order: np.ndarray         # walk permutation (len == n_walk)
    rel_src: np.ndarray       # src[order] - src[order[0]]
    rel_dst: np.ndarray       # dst[order] - dst[order[0]]
    length: np.ndarray        # length[order]
    config: np.ndarray        # config[order]
    src_base: int             # src[order[0]] (0 for empty chains)
    dst_base: int

    @property
    def n_walk(self) -> int:
        return int(self.order.size)

    @property
    def digest(self) -> bytes:
        """Exact relative-form fingerprint (base-address invariant)."""
        h = hashlib.blake2b(digest_size=16)
        h.update(np.int64(self.n_raw).tobytes())
        h.update(self.order.tobytes())
        h.update(self.rel_src.tobytes())
        h.update(self.rel_dst.tobytes())
        h.update(self.length.tobytes())
        h.update(self.config.tobytes())
        return h.digest()


def canonicalize(d: DescriptorArray,
                 head: int = 0) -> Optional[CanonicalChain]:
    """Walk-ordered relative form of a chain; None when the walk fails."""
    nxt = np.asarray(d.nxt, np.int64)
    order = walk_order(nxt, head)
    if order is None:
        return None
    src = np.asarray(d.src, np.int64)[order]
    dst = np.asarray(d.dst, np.int64)[order]
    ln = np.asarray(d.length, np.int64)[order]
    cfg = np.asarray(d.config, np.int64)[order]
    src0 = int(src[0]) if src.size else 0
    dst0 = int(dst[0]) if dst.size else 0
    return CanonicalChain(
        n_raw=int(d.num_descriptors), order=order,
        rel_src=src - src0, rel_dst=dst - dst0,
        length=ln, config=cfg, src_base=src0, dst_base=dst0)


@dataclasses.dataclass(frozen=True)
class ChainSignature:
    """The translation-cache key: what a compiled executor specializes on.

    Every field is invariant under a common base-address shift of the
    chain's src/dst ranges (DESIGN.md §7). ``unit`` is the *exact*
    uniform segment length (0 when lengths are mixed): the row-lowered
    kernel path reshapes pools into ``(rows, unit)`` and therefore needs
    the exact width as a static shape, while the masked vector path only
    needs the ``unit_class`` window.
    """

    tier: str                 # engine tier the artifact targets
    n_class: int              # pow2 bucket of active segment count
    unit_class: int           # pow2 bucket of the longest segment
    layout: str               # sequential | strided | gather
    unit: int                 # exact uniform segment length, 0 if mixed
    overlap: bool             # dst intervals overlap -> ordered execution
    aligned: bool             # rel offsets are multiples of `unit`
    depth_class: int          # pow2 bucket of the §II-C speculation depth
    transform: str = ""       # in-flight transform token ("" = identity,
                              # DESIGN.md §9) — fused into the executor


def _layout_of(rel_src: np.ndarray, rel_dst: np.ndarray,
               ln: np.ndarray) -> str:
    if ln.size <= 1:
        return LAYOUT_SEQUENTIAL
    ds, dd = np.diff(rel_src), np.diff(rel_dst)
    if np.array_equal(ds, ln[:-1]) and np.array_equal(dd, ln[:-1]):
        return LAYOUT_SEQUENTIAL
    uniform = ln.min() == ln.max()
    if (uniform and ds.min() == ds.max() and dd.min() == dd.max()):
        return LAYOUT_STRIDED
    return LAYOUT_GATHER


def _has_overlap(rel_dst: np.ndarray, ln: np.ndarray) -> bool:
    """Do any two segments' dst intervals intersect?"""
    if ln.size <= 1:
        return False
    o = np.argsort(rel_dst, kind="stable")
    t, l = rel_dst[o], ln[o]
    return bool(np.any(t[1:] < t[:-1] + l[:-1]))


def signature_of(canon: CanonicalChain, *, tier: str,
                 depth: int = 0, transform: str = "") -> ChainSignature:
    """Bucketed cache key of a canonical chain (active segments only)."""
    act = canon.length > 0
    rs, rd, ln = canon.rel_src[act], canon.rel_dst[act], canon.length[act]
    n = int(ln.size)
    if n == 0:
        return ChainSignature(tier=tier, n_class=1, unit_class=1,
                              layout=LAYOUT_SEQUENTIAL, unit=0,
                              overlap=False, aligned=False,
                              depth_class=pow2_bucket(depth) if depth else 0,
                              transform=transform)
    unit = int(ln[0]) if int(ln.min()) == int(ln.max()) else 0
    aligned = bool(unit > 0
                   and not np.any(rs % unit)
                   and not np.any(rd % unit))
    return ChainSignature(
        tier=tier,
        n_class=pow2_bucket(n),
        unit_class=pow2_bucket(int(ln.max())),
        layout=_layout_of(rs, rd, ln),
        unit=unit,
        overlap=_has_overlap(rd, ln),
        aligned=aligned,
        depth_class=pow2_bucket(depth) if depth else 0,
        transform=transform,
    )
