"""Plain-PyTorch oracles for the ported kernels (the `ref.py` contract).

Each oracle is pure: it returns a new tensor and leaves its inputs as they
were. The oracles of the kernels still to be ported follow them.
"""
from __future__ import annotations

import torch


def descriptor_copy_ref(src_idx, dst_idx, src: torch.Tensor,
                        dst: torch.Tensor) -> torch.Tensor:
    """Row gather/scatter: dst[dst_idx[i]] = src[src_idx[i]]; -1 skips.

    Pure (returns a new tensor). Of duplicate destination rows the last
    descriptor wins, the port's rule for every scatter.
    """
    from repro_torch.core.engine import scatter_drop
    from .descriptor_copy import host_indices

    sidx, didx = host_indices(src_idx), host_indices(dst_idx)
    rows = src[torch.from_numpy(sidx.clip(0, None)).to(src.device)]
    active = (sidx >= 0) & (didx >= 0)
    return scatter_drop(dst.clone(), didx, rows, valid=active)


def prefetched_chain_copy_ref(src_idx, dst_idx, src: torch.Tensor,
                              dst: torch.Tensor) -> torch.Tensor:
    """The prefetched chain copy run in chain order: -1 reads or writes
    row 0, the last descriptor per destination wins, and every read sees
    ``src`` as it was before the call. Pure (returns a new tensor)."""
    from .prefetch_pipeline import prefetched_chain_copy_plain

    return prefetched_chain_copy_plain(src_idx, dst_idx, src.clone(),
                                       dst.clone())


def paged_attention_ref(q, k_pages, v_pages, block_tables,
                        lengths) -> torch.Tensor:
    """Decode attention over a paged KV pool.

    q: (B, H, D); {k,v}_pages: (P, page, KV, D); block_tables:
    (B, max_pages) int32 page ids (-1 pads); lengths: (B,) int32 tokens in
    cache. Returns (B, H, D). On a row with no valid token it follows the
    kernel (zeros), where the JAX package's reference averages V.
    """
    from .paged_attention import paged_attention_plain

    return paged_attention_plain(q, k_pages, v_pages, block_tables, lengths)
