"""The speculative descriptor prefetch engine (§II-C) as a CUDA kernel.

``prefetched_chain_copy(src_idx, dst_idx, src, dst, depth=...)`` moves rows
like :func:`repro_torch.kernels.descriptor_copy.descriptor_copy`, but it
makes the paper's mechanism explicit: the chain is walked in order through
a ring of ``depth`` bounce buffers, and the fetch for descriptor
``i + depth`` is issued as soon as descriptor ``i``'s buffer has been
written out (``csrc/prefetch_pipeline.cu``). ``depth`` is the paper's
``prefetch`` parameter, clamped to ``[2, max(n, 2)]``; it shapes the
pipeline and never the result.

Semantics, those of the TPU kernel run in order:

* a **negative index reads or writes row 0** (both streams are clamped to
  0, as the TPU kernel does), where ``descriptor_copy`` skips it;
* of **duplicate destinations** the last descriptor wins;
* every read sees ``src`` **as it was before the call**, also when ``src``
  and ``dst`` share storage.

The destination is updated in place and returned. The wrapper launches
the kernel for CUDA tensors (or raises) and runs
:func:`prefetched_chain_copy_plain` for CPU tensors. On the CUDA route the
chain reaches the card inside the launch, as the TPU kernel's
scalar-prefetch operands do: the wrapper hands the library the bytes of
two contiguous int64 streams, and one C pass clamps them to
row 0, checks their range and packs them into the kernel's by-value table
of 128, 512 or 4,088 int32 pairs; a longer chain is cut into consecutive
launches on one stream, each counted. The last-write rule is applied on
the card (:func:`repro_torch.kernels.ref.last_write_keep` models it), and
when ``src`` and ``dst`` overlap in memory and a source row is also a
destination row the wrapper first copies the source rows to a scratch
pool, with one more call of the same kernel. Nothing uploads and nothing
synchronises.
"""
from __future__ import annotations

import numpy as np
import torch

from .build import refuse_grad
from .descriptor_copy import (
    check_pools,
    host_indices,
    int64_streams,
    launch_on_card,
    overlaps,
    prepare,
    unaliased_source,
)


def clamp_depth(depth: int, n: int) -> int:
    """The ring's depth as the TPU kernel clamps it: ``[2, max(n, 2)]``."""
    if isinstance(depth, bool) or not isinstance(depth, (int, np.integer)):
        raise TypeError(f"depth must be an int, got {type(depth).__name__}")
    return max(2, min(int(depth), max(n, 2)))


def _clamped(src_idx, dst_idx, src: torch.Tensor, dst: torch.Tensor,
             api: str):
    """Both streams clamped to row 0, then the duplicate and alias rules."""
    sidx, didx = host_indices(src_idx), host_indices(dst_idx)
    if sidx.shape != didx.shape:
        raise ValueError(f"{api}: {sidx.size} source vs {didx.size} "
                         "destination indices")
    return prepare(np.maximum(sidx, 0), np.maximum(didx, 0), src, dst, api)


def prefetched_chain_copy_plain(src_idx, dst_idx, src: torch.Tensor,
                                dst: torch.Tensor, *,
                                depth: int = 2) -> torch.Tensor:
    """Plain-PyTorch :func:`prefetched_chain_copy` (same rules, any
    device)."""
    check_pools(src, dst, "prefetched_chain_copy_plain")
    clamp_depth(depth, 0)
    sidx, didx, _ = _clamped(src_idx, dst_idx, src, dst,
                             "prefetched_chain_copy_plain")
    keep = sidx >= 0
    if keep.any():
        # The gather materialises the rows before the scatter: every read
        # sees the pool as it was before the call.
        rows = src[torch.from_numpy(sidx[keep]).to(src.device)]
        dst[torch.from_numpy(didx[keep]).to(dst.device)] = rows
    return dst


def _launch(src: torch.Tensor, dst: torch.Tensor, sidx: np.ndarray,
            didx: np.ndarray, depth: int) -> None:
    launch_on_card("prefetch_pipeline", src, dst, sidx, didx, depth)


def prefetched_chain_copy(src_idx, dst_idx, src: torch.Tensor,
                          dst: torch.Tensor, *,
                          depth: int = 2) -> torch.Tensor:
    """dst[dst_idx[i]] = src[src_idx[i]] in chain order through a
    ``depth``-deep prefetch ring, in place.

    src/dst: (rows, unit) row pools of one dtype (any) on one device. An
    index out of range raises ``IndexError`` before anything is written.
    """
    check_pools(src, dst, "prefetched_chain_copy")
    if dst.get_device() < 0:                       # on the CPU
        return prefetched_chain_copy_plain(src_idx, dst_idx, src, dst,
                                           depth=depth)
    refuse_grad("prefetched_chain_copy", src, dst)
    sidx, didx = int64_streams(src_idx, dst_idx, "prefetched_chain_copy")
    depth = clamp_depth(depth, sidx.size)
    if overlaps(src, dst):
        src, sidx = unaliased_source(
            src, dst, np.maximum(sidx, 0), np.maximum(didx, 0),
            lambda s, scratch, rows: _launch(
                s, scratch, rows, np.arange(rows.size),
                clamp_depth(depth, rows.size)))
    _launch(src, dst, sidx, didx, depth)
    return dst
