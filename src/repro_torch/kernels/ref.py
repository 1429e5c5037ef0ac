"""Plain-PyTorch oracles for the ported kernels (the `ref.py` contract).

Each oracle is pure: it returns a new tensor and leaves its inputs as they
were.
"""
from __future__ import annotations

from typing import Optional

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


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Naive softmax attention. q: (B, S, H, D); k, v: (B, S, KV, D).

    K and V are repeated per query head, as the JAX package's oracle does;
    the softmax runs over the full fp32 score matrix, -1e30 where masked.
    """
    b, sq, h, d = q.shape
    g = h // k.shape[2]
    kk = k.repeat_interleave(g, dim=2).float()
    vv = v.repeat_interleave(g, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * d ** -0.5
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= qi - ki < window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)


def moe_gather_ref(token_idx, tokens) -> torch.Tensor:
    """Dispatch gather: (E*C,) slots from (T, d) tokens; -1 -> zeros."""
    idx = token_idx.long()
    rows = tokens[idx.clamp_min(0)]
    return torch.where((idx >= 0)[:, None], rows,
                       torch.zeros((), dtype=tokens.dtype,
                                   device=tokens.device))


def moe_combine_ref(inv_slot, inv_weight, expert_out) -> torch.Tensor:
    """Combine: out[t] = sum_j w[t,j] * expert_out[inv_slot[t,j]]; -1 skips.

    The JAX package's einsum form (the sum order is the einsum's, so it
    agrees with the kernel within fp32 rounding, not bit for bit).
    """
    slots = inv_slot.long()
    rows = expert_out[slots.clamp_min(0)].float()           # (T, k, d)
    w = torch.where(slots >= 0, inv_weight, 0.0).float()
    rows = torch.where((slots >= 0)[..., None], rows, 0.0)
    return torch.einsum("tk,tkd->td", w, rows).to(expert_out.dtype)
