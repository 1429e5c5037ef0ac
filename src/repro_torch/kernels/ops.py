"""Public entry points for the hand-written CUDA kernels.

Each op takes tensors on the card (the kernel runs) or on the CPU (the
kernel's plain PyTorch version runs); the choice follows the tensors'
device, never the machine.
"""
from __future__ import annotations

from repro_torch.core.speculation import (
    DEFAULT_POLICY,
    PolicyLike,
    static_depth,
)

from . import ref  # noqa: F401  (re-exported oracles)
from .descriptor_copy import chain_copy, descriptor_copy
from .flash_attention import flash_attention
from .moe_dispatch import moe_combine, moe_gather
from .paged_attention import paged_attention
from .prefetch_pipeline import prefetched_chain_copy
from .quantize_copy import quantize_copy


def descriptor_copy_op(src_idx, dst_idx, src, dst):
    return descriptor_copy(src_idx, dst_idx, src, dst)


def chain_copy_op(descs, src, dst, head: int = 0):
    return chain_copy(descs, src, dst, head=head)


def quantize_copy_op(src_idx, dst_idx, src, dst):
    return quantize_copy(src_idx, dst_idx, src, dst)


def flash_attention_op(q, k, v, *, causal=True, window=None, softcap=None,
                       q_block=128, kv_block=128):
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, q_block=q_block,
                           kv_block=kv_block)


def paged_attention_op(q, k_pages, v_pages, block_tables, lengths):
    return paged_attention(q, k_pages, v_pages, block_tables, lengths)


def moe_gather_op(token_idx, tokens, inv_slot=None):
    return moe_gather(token_idx, tokens, inv_slot=inv_slot)


def moe_combine_op(inv_slot, inv_weight, expert_out, token_idx=None):
    return moe_combine(inv_slot, inv_weight, expert_out, token_idx=token_idx)


def prefetched_chain_copy_op(src_idx, dst_idx, src, dst,
                             depth: "PolicyLike | None" = None):
    """Chain copy through the explicit prefetch pipeline (§II-C).

    ``depth`` accepts an int, any
    :class:`repro_torch.core.speculation.SpeculationPolicy`, or ``None``
    for the shared :data:`repro_torch.core.speculation.DEFAULT_POLICY`,
    the same source the cycle model's speculation config reads.
    """
    resolved = static_depth(DEFAULT_POLICY if depth is None else depth)
    return prefetched_chain_copy(src_idx, dst_idx, src, dst, depth=resolved)
