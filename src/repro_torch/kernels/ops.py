"""Public entry points for the hand-written CUDA kernels.

Each op takes tensors on the card (the kernel runs) or on the CPU (the
kernel's plain PyTorch version runs); the choice follows the tensors'
device, never the machine.
"""
from __future__ import annotations

from . import ref  # noqa: F401  (re-exported oracles)
from .descriptor_copy import chain_copy, descriptor_copy
from .quantize_copy import quantize_copy


def descriptor_copy_op(src_idx, dst_idx, src, dst):
    return descriptor_copy(src_idx, dst_idx, src, dst)


def chain_copy_op(descs, src, dst, head: int = 0):
    return chain_copy(descs, src, dst, head=head)


def quantize_copy_op(src_idx, dst_idx, src, dst):
    return quantize_copy(src_idx, dst_idx, src, dst)
