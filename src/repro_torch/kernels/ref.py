"""Plain-PyTorch oracles for the ported kernels (the `ref.py` contract).

Only the descriptor copy's oracle is ported so far; the oracles of the
kernels still to be ported follow them.
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
