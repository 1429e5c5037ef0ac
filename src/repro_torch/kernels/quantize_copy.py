"""Descriptor-driven quantize-dequantize row copy (DMAC + in-flight kv_int8).

``quantize_copy(src_idx, dst_idx, src, dst)`` moves rows like
:func:`repro_torch.kernels.descriptor_copy.descriptor_copy`, but each row
passes through the EF-int8 per-256-block symmetric round trip of
:mod:`repro_torch.optim.compress` between the read and the write: the wire
carries int8 payload + one fp32 scale per block, the destination receives
dequantized values, computed in fp32 and stored in ``dst``'s dtype
(float32 or bfloat16). The destination is updated **in place** and
returned.

Bit-compatibility contract: for row width a multiple of ``BLOCK`` and
unit-aligned pools, a row's local 256-blocks coincide with the
pool-absolute blocks of :func:`repro_torch.core.transform.kv8_roundtrip`,
so this copy is value-identical to copying from the round-tripped pool.

As for the copy, the wrapper launches the CUDA kernel
(``csrc/quantize_copy.cu``) for CUDA tensors and runs
:func:`quantize_copy_plain` for CPU tensors; duplicate destinations keep
the last descriptor and aliased source rows are snapshotted first (the
snapshot itself is a ``descriptor_copy`` launch).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.compress import BLOCK, _dequantize, _quantize

from .build import launch, refuse_grad
from .descriptor_copy import (
    _launch_copy,
    check_pools,
    device_i32,
    pad_bucket,
    prepare,
    snapshot_rows,
    stream_of,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(src: torch.Tensor, dst: torch.Tensor, api: str) -> None:
    check_pools(src, dst, api)
    if src.dtype not in _DTYPE_CODE:
        raise TypeError(f"{api}: dtype {src.dtype} not supported "
                        "(float32 or bfloat16)")
    if src.shape[1] % BLOCK:
        raise ValueError(f"row width {src.shape[1]} is not a multiple "
                         f"of {BLOCK}")


def roundtrip_rows(rows: torch.Tensor) -> torch.Tensor:
    """The per-BLOCK int8 round trip of (k, unit) rows, in fp32."""
    q, scale = _quantize(rows.to(torch.float32).reshape(-1))
    return _dequantize(q, scale).reshape(rows.shape)


def quantize_copy_plain(src_idx, dst_idx, src: torch.Tensor,
                        dst: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch :func:`quantize_copy` (same rules, any device)."""
    _check(src, dst, "quantize_copy_plain")
    sidx, didx, _ = prepare(src_idx, dst_idx, src, dst,
                            "quantize_copy_plain")
    keep = sidx >= 0
    if keep.any():
        rows = src[torch.from_numpy(sidx[keep]).to(src.device)]
        dst[torch.from_numpy(didx[keep]).to(dst.device)] = \
            roundtrip_rows(rows).to(dst.dtype)
    return dst


def quantize_copy(src_idx, dst_idx, src: torch.Tensor,
                  dst: torch.Tensor) -> torch.Tensor:
    """dst[dst_idx[i]] = kv8_roundtrip(src[src_idx[i]]) per descriptor i.

    src/dst: (rows, unit) row pools with ``unit % BLOCK == 0``, float32 or
    bfloat16, on one device. In place; returns ``dst``.
    """
    _check(src, dst, "quantize_copy")
    if dst.device.type == "cpu":
        return quantize_copy_plain(src_idx, dst_idx, src, dst)
    refuse_grad("quantize_copy", src, dst)
    sidx, didx, snapshot = prepare(src_idx, dst_idx, src, dst,
                                   "quantize_copy")
    if not np.any(sidx >= 0):
        return dst
    if snapshot:
        rows, sidx = snapshot_rows(sidx)
        scratch = torch.empty((rows.size, src.shape[1]), dtype=src.dtype,
                              device=src.device)
        _launch_copy(src, scratch, rows, np.arange(rows.size))
        src = scratch
    dev = dst.device
    s, d = device_i32(sidx, didx, dev)
    with torch.cuda.device(dev):
        launch("quantize_copy", src.data_ptr(), dst.data_ptr(),
               s.data_ptr(), d.data_ptr(), int(sidx.size),
               int(src.shape[1]), _DTYPE_CODE[src.dtype], stream_of(dev))
    return dst


def quantize_copy_bucketed(src_idx, dst_idx, src: torch.Tensor,
                           dst: torch.Tensor, *,
                           n_bucket: int) -> torch.Tensor:
    """:func:`quantize_copy` over index streams padded to ``n_bucket``.

    Same pow2-bucket contract as ``descriptor_copy_bucketed``: ``-1``
    padding marks inactive entries.
    """
    sidx, didx = pad_bucket(src_idx, dst_idx, n_bucket)
    return quantize_copy(sidx, didx, src, dst)
