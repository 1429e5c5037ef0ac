"""MoE dispatch gather and combine, driven by the DispatchPlan streams,
and their backwards.

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

The backwards read the plan both ways. Its duality: each filled slot ``s``
(``token_idx[s] >= 0``) is the ``inv_slot`` of exactly one kept copy
``(t, j)``, and ``token_idx[s] == t`` there; no kept copy points at an
empty slot. So the gather's backward, a scatter-add of the slot rows by
``token_idx``, is the gather ``d_tokens[t] = sum_j d_slots[inv_slot[t, j]]``
(the combine with unit weights: fp32 in j order, cast once), and the
combine's backward writes ``d_expert_out[inv_slot[t, j]] = inv_weight[t, j]
* dy[t]`` (the product in fp32, rounded once; zeros in the empty slots) and
``d_inv_weight[t, j] = sum_d dy[t, d] * expert_out[inv_slot[t, j], d]`` in
fp32 (0 for a dropped copy). Under autograd the wrappers therefore take the
other stream too: ``moe_gather(..., inv_slot=)`` and ``moe_combine(...,
token_idx=)``, and raise without it.

Each wrapper launches ``csrc/moe_dispatch.cu`` for CUDA tensors (or
raises) and runs its plain version for CPU tensors (and meta tensors,
whose operations the dry run counts); under autograd it goes
through :class:`MoEGatherFn` / :class:`MoECombineFn`, whose backward is the
backward kernel on the card and the plain backward on the CPU. Kernels and
plain versions are bit-identical, ``d_inv_weight`` aside (a sum in another
order). Every kernel is deterministic: one writer per output element, no
atomics.
"""
from __future__ import annotations

import torch

from .build import DEVICES, launch, plain_device
from .descriptor_copy import stream_of

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_tensors(api: str, **tensors) -> None:
    """Tensors, all on one CPU, meta or CUDA device."""
    dev = None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{api}: {name} must be a torch.Tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{api}: {name} on {t.device}, expected {dev}")
    if dev.type not in DEVICES:
        raise ValueError(f"{api}: unsupported device {dev}")


def _check_gather(token_idx, tokens, api: str) -> None:
    _check_tensors(api, token_idx=token_idx, tokens=tokens)
    if token_idx.dtype != torch.int32 or token_idx.ndim != 1:
        raise TypeError(f"{api}: token_idx must be (N,) int32, got "
                        f"{token_idx.dtype} {tuple(token_idx.shape)}")
    if tokens.ndim != 2:
        raise ValueError(f"{api}: tokens must be (T, d), got "
                         f"{tuple(tokens.shape)}")


def _check_slots(inv_slot, rows, api: str, name: str) -> None:
    """(T, k) int32 ``inv_slot`` over (rows, d) ``rows`` of float32 or
    bfloat16, both on one device."""
    _check_tensors(api, inv_slot=inv_slot, **{name: rows})
    if inv_slot.dtype != torch.int32 or inv_slot.ndim != 2:
        raise TypeError(f"{api}: inv_slot must be (T, k) int32, got "
                        f"{inv_slot.dtype} {tuple(inv_slot.shape)}")
    if rows.dtype not in _DTYPE_CODE or rows.ndim != 2:
        raise TypeError(f"{api}: {name} must be (rows, d) float32 or "
                        f"bfloat16, got {rows.dtype} {tuple(rows.shape)}")


def _check_combine(inv_slot, inv_weight, expert_out, api: str) -> None:
    _check_slots(inv_slot, expert_out, api, "expert_out")
    _check_tensors(api, inv_slot=inv_slot, inv_weight=inv_weight)
    if inv_weight.dtype != torch.float32 \
            or inv_weight.shape != inv_slot.shape:
        raise TypeError(f"{api}: inv_weight must be float32 of inv_slot's "
                        f"shape, got {inv_weight.dtype} "
                        f"{tuple(inv_weight.shape)}")


def moe_gather_plain(token_idx, tokens) -> torch.Tensor:
    """Plain-PyTorch :func:`moe_gather` (same rules, any device)."""
    _check_gather(token_idx, tokens, "moe_gather_plain")
    idx = token_idx.long()
    valid = (idx >= 0)[:, None]
    rows = tokens[idx.clamp_min(0)]
    return torch.where(valid, rows, torch.zeros((), dtype=tokens.dtype,
                                                device=tokens.device))


def _gather(token_idx, tokens) -> torch.Tensor:
    """The forward gather: the kernel on the card, the plain version on
    the CPU."""
    if plain_device(tokens):
        return moe_gather_plain(token_idx, tokens)
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


def moe_gather(token_idx, tokens, inv_slot=None) -> torch.Tensor:
    """(N, d) slot rows gathered from (T, d) tokens (see the module). When
    grad is enabled and ``tokens`` requires it, ``inv_slot`` (the plan's
    (T, k) inverse stream) is needed for the backward."""
    _check_gather(token_idx, tokens, "moe_gather")
    if torch.is_grad_enabled() and tokens.requires_grad:
        if inv_slot is None:
            raise RuntimeError("moe_gather: tokens require grad, and the "
                               "backward needs the plan's inv_slot=")
        _check_inverse(inv_slot, tokens, "moe_gather")
        return MoEGatherFn.apply(token_idx, tokens, inv_slot)
    return _gather(token_idx, tokens)


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


def _combine(inv_slot, inv_weight, expert_out) -> torch.Tensor:
    """The forward combine: the kernel on the card, the plain version on
    the CPU."""
    if plain_device(expert_out):
        return moe_combine_plain(inv_slot, inv_weight, expert_out)
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


def moe_combine(inv_slot, inv_weight, expert_out,
                token_idx=None) -> torch.Tensor:
    """(T, d) token rows combined from (rows, d) expert outputs (see the
    module). When grad is enabled and ``inv_weight`` or ``expert_out``
    requires it, ``token_idx`` (the plan's (rows,) forward stream) is
    needed for the backward."""
    _check_combine(inv_slot, inv_weight, expert_out, "moe_combine")
    if torch.is_grad_enabled() and (inv_weight.requires_grad
                                    or expert_out.requires_grad):
        if token_idx is None:
            raise RuntimeError("moe_combine: an input requires grad, and "
                               "the backward needs the plan's token_idx=")
        _check_forward_stream(token_idx, expert_out, "moe_combine")
        return MoECombineFn.apply(inv_slot, inv_weight, expert_out,
                                  token_idx)
    return _combine(inv_slot, inv_weight, expert_out)


# ---------------------------------------------------------------------------
# The backwards
# ---------------------------------------------------------------------------

def _check_inverse(inv_slot, tokens, api: str) -> None:
    """``inv_slot`` is the (T, k) int32 inverse stream of ``tokens``' T rows,
    and ``tokens`` a dtype the backward sums in."""
    _check_tensors(api, inv_slot=inv_slot, tokens=tokens)
    if inv_slot.dtype != torch.int32 or inv_slot.ndim != 2 \
            or inv_slot.shape[0] != tokens.shape[0]:
        raise TypeError(f"{api}: inv_slot must be ({tokens.shape[0]}, k) "
                        f"int32, got {inv_slot.dtype} "
                        f"{tuple(inv_slot.shape)}")
    if tokens.dtype not in _DTYPE_CODE:
        raise TypeError(f"{api}: the backward takes float32 or bfloat16 "
                        f"tokens, got {tokens.dtype}")


def _check_forward_stream(token_idx, expert_out, api: str) -> None:
    _check_tensors(api, token_idx=token_idx, expert_out=expert_out)
    if token_idx.dtype != torch.int32 \
            or tuple(token_idx.shape) != (expert_out.shape[0],):
        raise TypeError(f"{api}: token_idx must be ({expert_out.shape[0]},) "
                        f"int32, got {token_idx.dtype} "
                        f"{tuple(token_idx.shape)}")


def moe_gather_backward_plain(inv_slot, d_slots) -> torch.Tensor:
    """Plain-PyTorch :func:`moe_gather_backward` (same order and rounding,
    any device): ``acc + row`` per kept copy, in j order, in fp32."""
    _check_slots(inv_slot, d_slots, "moe_gather_backward_plain", "d_slots")
    t, _ = inv_slot.shape
    acc = torch.zeros((t, d_slots.shape[1]), dtype=torch.float32,
                      device=d_slots.device)
    slots = inv_slot.long()
    for j in range(slots.shape[1]):
        valid = (slots[:, j] >= 0)[:, None]
        rows = d_slots[slots[:, j].clamp_min(0)].float()
        acc = torch.where(valid, acc + rows, acc)
    return acc.to(d_slots.dtype)


def moe_gather_backward(inv_slot, d_slots) -> torch.Tensor:
    """(T, d) gradient of :func:`moe_gather`'s tokens from the (rows, d)
    gradient of its slots, through the inverse plan (see the module)."""
    _check_slots(inv_slot, d_slots, "moe_gather_backward", "d_slots")
    if plain_device(d_slots):
        return moe_gather_backward_plain(inv_slot, d_slots)
    if not (inv_slot.is_contiguous() and d_slots.is_contiguous()):
        raise ValueError("moe_gather_backward: every input must be "
                         "contiguous")
    t, k = inv_slot.shape
    d = d_slots.shape[1]
    out = torch.empty((t, d), dtype=d_slots.dtype, device=d_slots.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    with torch.cuda.device(d_slots.device):
        launch("moe_gather_bwd", inv_slot.data_ptr(), d_slots.data_ptr(),
               out.data_ptr(), t, d, k, _DTYPE_CODE[d_slots.dtype],
               stream_of(d_slots.device))
    return out


def _check_combine_backward(inv_slot, inv_weight, expert_out, dy,
                            api: str) -> None:
    _check_combine(inv_slot, inv_weight, expert_out, api)
    _check_tensors(api, expert_out=expert_out, dy=dy)
    want = (inv_slot.shape[0], expert_out.shape[1])
    if dy.dtype != expert_out.dtype or tuple(dy.shape) != want:
        raise TypeError(f"{api}: dy must be {want} in {expert_out.dtype}, "
                        f"got {dy.dtype} {tuple(dy.shape)}")


def moe_combine_backward_plain(inv_slot, inv_weight, expert_out, dy):
    """Plain-PyTorch :func:`moe_combine_backward` (any device):
    ``d_expert_out`` with the kernel's rounding (the fp32 product, rounded
    once), ``d_inv_weight`` summed in another order."""
    _check_combine_backward(inv_slot, inv_weight, expert_out, dy,
                            "moe_combine_backward_plain")
    t, k = inv_slot.shape
    rows, d = expert_out.shape
    slots = inv_slot.long()
    kept = slots >= 0
    g = dy.float()
    # Dropped copies write to an overflow row that is cut away.
    d_eo = expert_out.new_zeros((rows + 1, d))
    d_eo[torch.where(kept, slots, rows).reshape(-1)] = (
        inv_weight[:, :, None] * g[:, None, :]).to(expert_out.dtype).reshape(
            t * k, d)
    d_w = torch.zeros((t, k), dtype=torch.float32, device=dy.device)
    for j in range(k):
        row = expert_out[slots[:, j].clamp_min(0)].float()
        d_w[:, j] = torch.where(kept[:, j], (row * g).sum(-1), 0.0)
    return d_eo[:rows], d_w


def moe_combine_backward(inv_slot, inv_weight, expert_out, dy,
                         token_idx=None):
    """``(d_expert_out, d_inv_weight)`` of :func:`moe_combine` from the
    (T, d) gradient ``dy`` of its output (see the module). The kernel needs
    the plan's ``token_idx`` to zero the empty slots; the plain version on
    the CPU does not."""
    _check_combine_backward(inv_slot, inv_weight, expert_out, dy,
                            "moe_combine_backward")
    if plain_device(expert_out):
        return moe_combine_backward_plain(inv_slot, inv_weight, expert_out,
                                          dy)
    if token_idx is None:
        raise ValueError("moe_combine_backward: the kernel needs the plan's "
                         "token_idx")
    _check_forward_stream(token_idx, expert_out, "moe_combine_backward")
    tensors = (inv_slot, inv_weight, expert_out, dy, token_idx)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("moe_combine_backward: every input must be "
                         "contiguous")
    t, k = inv_slot.shape
    rows, d = expert_out.shape
    d_eo = torch.empty_like(expert_out)
    d_w = torch.empty((t, k), dtype=torch.float32, device=dy.device)
    if d == 0 or k == 0:
        return d_eo.zero_(), d_w.zero_()
    if t + rows == 0:
        return d_eo, d_w
    with torch.cuda.device(expert_out.device):
        launch("moe_combine_bwd", inv_slot.data_ptr(), inv_weight.data_ptr(),
               expert_out.data_ptr(), dy.data_ptr(), token_idx.data_ptr(),
               d_eo.data_ptr(), d_w.data_ptr(), t, rows, d, k,
               _DTYPE_CODE[expert_out.dtype], stream_of(expert_out.device))
    return d_eo, d_w


class MoEGatherFn(torch.autograd.Function):
    """:func:`moe_gather` with its gradient: the forward keeps the inverse
    plan, the backward is :func:`moe_gather_backward`."""

    @staticmethod
    def forward(ctx, token_idx, tokens, inv_slot):
        ctx.save_for_backward(inv_slot)
        return _gather(token_idx, tokens)

    @staticmethod
    def backward(ctx, d_slots):
        inv_slot, = ctx.saved_tensors
        return None, moe_gather_backward(inv_slot, d_slots.contiguous()), None


class MoECombineFn(torch.autograd.Function):
    """:func:`moe_combine` with its gradients: the backward is
    :func:`moe_combine_backward`, one launch for both outputs."""

    @staticmethod
    def forward(ctx, inv_slot, inv_weight, expert_out, token_idx):
        ctx.save_for_backward(inv_slot, inv_weight, expert_out, token_idx)
        return _combine(inv_slot, inv_weight, expert_out)

    @staticmethod
    def backward(ctx, dy):
        inv_slot, inv_weight, expert_out, token_idx = ctx.saved_tensors
        d_eo, d_w = moe_combine_backward(inv_slot, inv_weight, expert_out,
                                         dy.contiguous(), token_idx=token_idx)
        return (None, d_w if ctx.needs_input_grad[1] else None,
                d_eo if ctx.needs_input_grad[2] else None, None)
