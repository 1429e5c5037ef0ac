"""MoE dispatch gather and combine, driven by the DispatchPlan streams.

``moe_gather(token_idx, tokens)``: slot ``s`` of the (E*C, d) output gets
token row ``tokens[token_idx[s]]``, or zeros where ``token_idx[s] < 0``, in
tokens' dtype (the paper's gather: src = token row, dst = expert slot).

``moe_combine(inv_slot, inv_weight, expert_out)``: token ``t`` of the
(T, d) output gets ``sum_j inv_weight[t, j] * expert_out[inv_slot[t, j]]``
over the ``j`` with ``inv_slot[t, j] >= 0``, in that order, accumulated in
fp32 and cast once to expert_out's dtype. A -1 entry is skipped without
reading any row, so a non-finite row cannot leak into the sum (the TPU
kernel reads row 0 there and multiplies it by 0).

* token_idx: (N,) int32, each -1 or < T; tokens: (T, d), any dtype.
* inv_slot: (T, k) int32, each -1 or < the rows of expert_out;
  inv_weight: (T, k) float32; expert_out: (rows, d) float32 or bfloat16.
* All on one device, contiguous. The indices are not range-checked on the
  card (that would cost a synchronisation): the plan gives them in range.

Each wrapper launches ``csrc/moe_dispatch.cu`` for CUDA tensors (or
raises) and runs its plain version for CPU tensors. Kernel and plain
version are bit-identical.
"""
from __future__ import annotations

import torch

from .build import launch, refuse_grad
from .descriptor_copy import stream_of

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_tensors(api: str, **tensors) -> None:
    """Tensors, all on one CPU or CUDA device."""
    dev = None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{api}: {name} must be a torch.Tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{api}: {name} on {t.device}, expected {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{api}: unsupported device {dev}")


def _check_gather(token_idx, tokens, api: str) -> None:
    _check_tensors(api, token_idx=token_idx, tokens=tokens)
    if token_idx.dtype != torch.int32 or token_idx.ndim != 1:
        raise TypeError(f"{api}: token_idx must be (N,) int32, got "
                        f"{token_idx.dtype} {tuple(token_idx.shape)}")
    if tokens.ndim != 2:
        raise ValueError(f"{api}: tokens must be (T, d), got "
                         f"{tuple(tokens.shape)}")


def _check_combine(inv_slot, inv_weight, expert_out, api: str) -> None:
    _check_tensors(api, inv_slot=inv_slot, inv_weight=inv_weight,
                   expert_out=expert_out)
    if inv_slot.dtype != torch.int32 or inv_slot.ndim != 2:
        raise TypeError(f"{api}: inv_slot must be (T, k) int32, got "
                        f"{inv_slot.dtype} {tuple(inv_slot.shape)}")
    if inv_weight.dtype != torch.float32 \
            or inv_weight.shape != inv_slot.shape:
        raise TypeError(f"{api}: inv_weight must be float32 of inv_slot's "
                        f"shape, got {inv_weight.dtype} "
                        f"{tuple(inv_weight.shape)}")
    if expert_out.dtype not in _DTYPE_CODE or expert_out.ndim != 2:
        raise TypeError(f"{api}: expert_out must be (rows, d) float32 or "
                        f"bfloat16, got {expert_out.dtype} "
                        f"{tuple(expert_out.shape)}")


def moe_gather_plain(token_idx, tokens) -> torch.Tensor:
    """Plain-PyTorch :func:`moe_gather` (same rules, any device)."""
    _check_gather(token_idx, tokens, "moe_gather_plain")
    idx = token_idx.long()
    valid = (idx >= 0)[:, None]
    rows = tokens[idx.clamp_min(0)]
    return torch.where(valid, rows, torch.zeros((), dtype=tokens.dtype,
                                                device=tokens.device))


def moe_gather(token_idx, tokens) -> torch.Tensor:
    """(N, d) slot rows gathered from (T, d) tokens (see the module)."""
    _check_gather(token_idx, tokens, "moe_gather")
    if tokens.device.type == "cpu":
        return moe_gather_plain(token_idx, tokens)
    refuse_grad("moe_gather", tokens)
    if not (token_idx.is_contiguous() and tokens.is_contiguous()):
        raise ValueError("moe_gather: token_idx and tokens must be contiguous")
    out = torch.empty((token_idx.shape[0], tokens.shape[1]),
                      dtype=tokens.dtype, device=tokens.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(tokens.device):
        launch("moe_gather", tokens.data_ptr(), out.data_ptr(),
               token_idx.data_ptr(), token_idx.shape[0],
               tokens.shape[1] * tokens.element_size(),
               stream_of(tokens.device))
    return out


def moe_combine_plain(inv_slot, inv_weight, expert_out) -> torch.Tensor:
    """Plain-PyTorch :func:`moe_combine` (same rules and rounding, any
    device): ``acc + w * row`` per kept copy, in order, product and sum
    each rounded to fp32."""
    _check_combine(inv_slot, inv_weight, expert_out, "moe_combine_plain")
    t, k = inv_slot.shape
    acc = torch.zeros((t, expert_out.shape[1]), dtype=torch.float32,
                      device=expert_out.device)
    slots = inv_slot.long()
    for j in range(k):
        valid = (slots[:, j] >= 0)[:, None]
        rows = expert_out[slots[:, j].clamp_min(0)].float()
        acc = torch.where(valid, acc + inv_weight[:, j, None] * rows, acc)
    return acc.to(expert_out.dtype)


def moe_combine(inv_slot, inv_weight, expert_out) -> torch.Tensor:
    """(T, d) token rows combined from (rows, d) expert outputs (see the
    module)."""
    _check_combine(inv_slot, inv_weight, expert_out, "moe_combine")
    if expert_out.device.type == "cpu":
        return moe_combine_plain(inv_slot, inv_weight, expert_out)
    refuse_grad("moe_combine", inv_weight, expert_out)
    tensors = (inv_slot, inv_weight, expert_out)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("moe_combine: every input must be contiguous")
    t, k = inv_slot.shape
    d = expert_out.shape[1]
    out = torch.empty((t, d), dtype=expert_out.dtype,
                      device=expert_out.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    with torch.cuda.device(expert_out.device):
        launch("moe_combine", inv_slot.data_ptr(), inv_weight.data_ptr(),
               expert_out.data_ptr(), out.data_ptr(), t, d, k,
               _DTYPE_CODE[expert_out.dtype], stream_of(expert_out.device))
    return out
