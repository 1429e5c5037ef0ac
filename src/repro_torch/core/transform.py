"""In-flight transform stage for the descriptor datapath (DESIGN.md §9).

XDMA (arXiv 2508.08396) extends DMA datapaths with pluggable transform
engines so data is reshaped *during* the transfer; iDMA (arXiv 2305.05240)
shows the frontend/midend/backend split that makes such stages composable.
This module is the reproduction's midend: a :class:`TransformSpec`
attached to a descriptor-chain submission names what happens to every
payload byte between the source read and the destination write:

* ``identity``   — plain copy (the default; bit-identical legacy path);
* ``transpose``  — the source pool is read through a ``(rows, cols)``
  transposed view (layout-mismatched engine tiers). Not merge-safe: the
  coalescer must not fuse descriptors whose *source-view* contiguity
  differs from pool contiguity, so transformed chains submit unmerged;
* ``kv_int8``    — KV-cache quantize/dequantize in flight: every payload
  element is read through the EF-int8 per-256-block symmetric round trip
  of :mod:`repro_torch.optim.compress`. The wire carries int8 blocks + fp32
  scales (``payload_ratio`` ≈ 0.254 — the cycle simulator charges fewer
  bus beats), the destination receives dequantized values. Because the
  round trip is a pure function of the *source pool*, the transform is
  merge/split-invariant: coalesced execution is bit-identical to
  unmerged execution;
* ``reduce_sum`` — fused ingress reduction (MoE combine): transferred
  bytes *add into* the destination instead of overwriting it
  (``dst' = dst + copy(d, src, zeros)``; overlapping writes inside one
  chain resolve last-write-wins before the add, matching the serial
  engine's chain-order semantics).

``cache_token`` joins :class:`repro_torch.core.signature.ChainSignature` so the
chain-lowering JIT compiles transform-fused executors per signature
bucket. :func:`reference_apply` is the numpy oracle every executor is
tested against.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from repro_torch.optim.compress import (
    BLOCK,
    _dequantize,
    _quantize,
    compression_ratio,
)

#: Transform kinds and their signature tokens (identity's token is ""
#: so untransformed signatures — and their cached artifacts — are
#: unchanged from the pre-transform cache layout).
KINDS = ("identity", "transpose", "kv_int8", "reduce_sum")


@dataclasses.dataclass(frozen=True)
class TransformSpec:
    """What happens to payload bytes in flight (immutable, hashable).

    ``rows``/``cols`` parameterize ``transpose`` only (the source pool is
    read as a ``(rows, cols)`` matrix, transposed); other kinds ignore
    them.
    """

    kind: str = "identity"
    rows: int = 0
    cols: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown transform {self.kind!r}; "
                             f"one of {KINDS}")
        if self.kind == "transpose" and (self.rows < 1 or self.cols < 1):
            raise ValueError("transpose needs rows >= 1 and cols >= 1")

    # -- constructors --------------------------------------------------------
    @staticmethod
    def identity() -> "TransformSpec":
        return TransformSpec("identity")

    @staticmethod
    def transpose(rows: int, cols: int) -> "TransformSpec":
        return TransformSpec("transpose", rows=rows, cols=cols)

    @staticmethod
    def kv_int8() -> "TransformSpec":
        return TransformSpec("kv_int8")

    @staticmethod
    def reduce_sum() -> "TransformSpec":
        return TransformSpec("reduce_sum")

    # -- contract ------------------------------------------------------------
    @property
    def is_identity(self) -> bool:
        return self.kind == "identity"

    @property
    def payload_ratio(self) -> float:
        """Wire bytes per logical byte — what the cycle simulator charges."""
        return compression_ratio() if self.kind == "kv_int8" else 1.0

    @property
    def merge_safe(self) -> bool:
        """May the coalescer fuse adjacent descriptors under this transform?

        True whenever the transform is a pure function of the source pool
        (merged and unmerged execution read identical bytes). Transposed
        reads break pool contiguity, so ``transpose`` submits unmerged.
        """
        return self.kind != "transpose"

    @property
    def cache_token(self) -> str:
        """The transform's component of the chain-lowering signature key."""
        if self.kind == "identity":
            return ""
        if self.kind == "kv_int8":
            return "kv8"
        if self.kind == "reduce_sum":
            return "sum"
        return f"t{self.rows}x{self.cols}"


#: Shared identity instance (the default on every submission path).
IDENTITY = TransformSpec.identity()

TransformLike = Union[None, str, TransformSpec]

_BY_NAME = {
    "identity": IDENTITY,
    "kv_int8": TransformSpec.kv_int8(),
    "reduce_sum": TransformSpec.reduce_sum(),
}


def as_transform(spec: TransformLike) -> TransformSpec:
    """Coerce ``None`` / a kind name / a spec to a :class:`TransformSpec`."""
    if spec is None:
        return IDENTITY
    if isinstance(spec, TransformSpec):
        return spec
    if isinstance(spec, str):
        t = _BY_NAME.get(spec)
        if t is None:
            raise ValueError(
                f"unknown transform {spec!r}; one of {sorted(_BY_NAME)} "
                "(transpose needs TransformSpec.transpose(rows, cols))")
        return t
    raise TypeError(f"cannot interpret {spec!r} as a TransformSpec")


# ---------------------------------------------------------------------------
# The kv_int8 round trip (torch + numpy oracle)
# ---------------------------------------------------------------------------

def kv8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """dequantize(quantize(x)) through EF-int8 per-256-block scales.

    Pool-absolute semantics: blocks partition the *flattened pool* (zero
    padding to a BLOCK multiple), so the round trip is independent of any
    descriptor layout — the property that makes ``kv_int8`` merge-safe.
    The division stays a true division and ``torch.round`` rounds half to
    even, as ``jnp.round`` does. Returns ``x``'s shape and dtype.
    """
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % BLOCK
    deq = _dequantize(*_quantize(torch.nn.functional.pad(flat, (0, pad))))
    return deq[:flat.numel()].reshape(x.shape).to(x.dtype)


def kv8_roundtrip_np(x) -> np.ndarray:
    """Numpy oracle of :func:`kv8_roundtrip` (same blocks, same rounding)."""
    x = _to_numpy(x)
    flat = x.astype(np.float32).reshape(-1)
    pad = (-flat.size) % BLOCK
    blocks = np.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = np.maximum(
        np.max(np.abs(blocks), axis=1, keepdims=True) / np.float32(127.0),
        np.float32(1e-12))
    q = np.clip(np.round(blocks / scale), -127, 127).astype(np.int8)
    deq = (q.astype(np.float32) * scale).reshape(-1)[:flat.size]
    return deq.reshape(x.shape).astype(x.dtype)


def transform_source_view(spec: TransformSpec,
                          src: torch.Tensor) -> torch.Tensor:
    """The effective source pool a transformed copy reads from.

    Applies to the *read side* only; ``reduce_sum`` (a write-side
    transform) and ``identity`` return ``src`` unchanged.
    """
    if spec.kind == "kv_int8":
        return kv8_roundtrip(src)
    if spec.kind == "transpose":
        if src.ndim != 1:
            raise ValueError("transpose transform needs a flat source pool")
        if src.shape[0] != spec.rows * spec.cols:
            raise ValueError(
                f"transpose({spec.rows}x{spec.cols}) does not tile a "
                f"pool of {src.shape[0]} elements")
        return src.reshape(spec.rows, spec.cols).T.reshape(-1)
    return src


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def reference_apply(spec: TransformSpec, d, src, dst,
                    head: int = 0) -> np.ndarray:
    """Numpy oracle: execute chain ``d`` with ``spec`` on host pools.

    Walks the chain in link order (last write wins, as the serial engine
    does) and applies the transform's read-side view / write-side
    reduction. Every lowered executor and channel drain is tested
    bit-identical (or, for ``kv_int8``, value-identical) to this.
    """
    from repro_torch.core.signature import walk_order

    src = _to_numpy(src)
    out = np.array(_to_numpy(dst), copy=True)
    order = walk_order(np.asarray(d.nxt, np.int64), head)
    if order is None:
        raise ValueError("malformed chain")
    if spec.kind == "kv_int8":
        src = kv8_roundtrip_np(src)
    elif spec.kind == "transpose":
        if src.ndim != 1 or src.shape[0] != spec.rows * spec.cols:
            raise ValueError("transpose view does not tile the source pool")
        src = np.ascontiguousarray(
            src.reshape(spec.rows, spec.cols).T).reshape(-1)
    target = np.zeros_like(out) if spec.kind == "reduce_sum" else out
    lengths = np.asarray(d.length, np.int64)
    srcs = np.asarray(d.src, np.int64)
    dsts = np.asarray(d.dst, np.int64)
    for i in order:
        ln = int(lengths[i])
        if ln <= 0:
            continue
        s, t = int(srcs[i]), int(dsts[i])
        target[t:t + ln] = src[s:s + ln]
    if spec.kind == "reduce_sum":
        out = out + target
    return out
