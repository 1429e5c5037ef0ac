"""Plain-PyTorch oracles for the ported kernels (the `ref.py` contract).

Each oracle is pure: it returns a new tensor and leaves its inputs as they
were.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
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


def table_launches(src_idx, dst_idx, *, clamp: bool = False,
                   cap: Optional[int] = None) -> list:
    """The host pass of the copy kernels' launch functions
    (``csrc/desc_table.cuh``), in numpy: with ``clamp`` negative indices
    become row 0 (``prefetched_chain_copy``), else a -1 on either side
    drops the descriptor (``descriptor_copy``); what is left is cut, in
    chain order, into launches of at most ``cap`` (default the largest
    table, ``MAX_TABLE``) int32 (src, dst) pairs. Returns the launches."""
    from .descriptor_copy import MAX_TABLE, host_indices

    cap = MAX_TABLE if cap is None else cap
    s, d = host_indices(src_idx), host_indices(dst_idx)
    if clamp:
        s, d = np.maximum(s, 0), np.maximum(d, 0)
    active = (s >= 0) & (d >= 0)
    s, d = s[active].astype(np.int32), d[active].astype(np.int32)
    return [(s[i:i + cap], d[i:i + cap]) for i in range(0, s.size, cap)]


def last_write_keep(dst_rows) -> np.ndarray:
    """The kernels' duplicate rule over one launch's table, descriptor by
    descriptor as a warp decides it on the card: descriptor i writes
    unless a later descriptor of the launch has the same destination."""
    d = np.asarray(dst_rows)
    return np.array([not np.any(d[i + 1:] == d[i]) for i in range(d.size)],
                    dtype=bool)


def table_copy_ref(src_idx, dst_idx, src: torch.Tensor, dst: torch.Tensor,
                   *, clamp: bool = False,
                   cap: Optional[int] = None) -> torch.Tensor:
    """The copy kernels' route modelled in plain PyTorch: the launches of
    :func:`table_launches` in stream order, each writing the rows that
    :func:`last_write_keep` keeps, every read seeing ``src`` as it was
    before the call. Pure (returns a new tensor)."""
    out, base = dst.clone(), src.clone()
    for s, d in table_launches(src_idx, dst_idx, clamp=clamp, cap=cap):
        keep = last_write_keep(d)
        out[torch.from_numpy(d[keep]).long().to(out.device)] = \
            base[torch.from_numpy(s[keep]).long().to(base.device)]
    return out


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
