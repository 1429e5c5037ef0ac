"""Per-block symmetric int8 quantization (the EF-int8 block format).

The port carries only what the in-flight ``kv_int8`` transform needs: the
block size, the quantize/dequantize pair and the wire ratio. The
error-feedback all-reduce of the JAX package is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 256


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization. x: flat fp32 (padded)."""
    blocks = x.reshape(-1, BLOCK)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    # Divide by a tensor, not a Python float: on CUDA, PyTorch turns a
    # division by a host scalar into a multiplication by its reciprocal,
    # which can miss the true quotient (jnp's, and the kernel's) by an ulp.
    scale = torch.clamp_min(amax / amax.new_full((), 127.0), 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(-1)


def compression_ratio() -> float:
    """Wire bytes vs fp32: int8 payload + fp32 scale per 256-block."""
    return (BLOCK * 1 + 4) / (BLOCK * 4)
