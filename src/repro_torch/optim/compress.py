"""Error-feedback int8 gradient compression for the slow (cross-pod) axis.

Per-block symmetric int8 quantization (blocks of 256 with an fp32 scale,
the format the in-flight ``kv_int8`` transform also uses) and the
reference's error-feedback all-reduce over a mesh axis's process group:
``flat = g + r`` padded to 256, ``sent`` its int8 image dequantized, the
new residual ``flat - sent``, and the reduced gradient ``sum_ranks sent /
n``. What crosses the axis is the int8 blocks and their fp32 scales, as
:func:`compression_ratio` counts: every rank all-gathers them, then
dequantizes and sums in rank order in fp32 (the reference psums the fp32
``sent``; at two ranks the sums are bit-equal, at more they differ in
order only). :data:`WIRE_BYTES` counts the bytes each rank sent in both
forms.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.tree import flatten, map_with_path, tree_map

BLOCK = 256

#: Bytes this rank sent across the axis: ``int8`` (blocks and scales, as
#: sent) and ``fp32`` (what a psum of the fp32 gradient would send).
WIRE_BYTES: Dict[str, int] = {"int8": 0, "fp32": 0}


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


def _encode(g: torch.Tensor, residual: torch.Tensor):
    """(int8 blocks, scales, sent, new residual) of one leaf."""
    flat = g.float().reshape(-1) + residual.reshape(-1)
    n = flat.numel()
    flat_p = torch.nn.functional.pad(flat, (0, (-n) % BLOCK))
    q, scale = _quantize(flat_p)
    sent = _dequantize(q, scale)[:n]
    return q, scale, sent, (flat - sent).reshape(g.shape)


def _reduce(qs: List[torch.Tensor], scales: List[torch.Tensor], n: int,
            shape) -> torch.Tensor:
    """``sum_ranks sent / ranks`` from every rank's blocks, in rank order."""
    acc = _dequantize(qs[0], scales[0])[:n]
    for q, scale in zip(qs[1:], scales[1:]):
        acc = acc + _dequantize(q, scale)[:n]
    return (acc / torch.tensor(float(len(qs)), device=acc.device)
            ).reshape(shape)


def _compressed(flat_g: List[torch.Tensor], flat_r: List[torch.Tensor],
                axis_name: str):
    """The EF-int8 all-reduce of a list of leaves: every leaf's blocks and
    scales cross in one all-gather each. Returns (reduced, residuals)."""
    # Not at import: repro_torch.distributed imports the runtime, whose
    # transforms import this module's block format.
    from repro_torch.distributed import shardlib
    enc = [_encode(g, r) for g, r in zip(flat_g, flat_r)]
    qs = torch.cat([q.reshape(-1) for q, _, _, _ in enc])
    scales = torch.cat([s.reshape(-1) for _, s, _, _ in enc])
    all_q = shardlib.all_gather(qs, axis_name)
    all_s = shardlib.all_gather(scales, axis_name)
    WIRE_BYTES["int8"] += qs.nbytes + scales.nbytes
    WIRE_BYTES["fp32"] += 4 * sum(g.numel() for g in flat_g)
    out, q0, s0 = [], 0, 0
    for g, (q, scale, _, _) in zip(flat_g, enc):
        nq, ns = q.numel(), scale.numel()
        out.append(_reduce([a[q0:q0 + nq].view(-1, BLOCK) for a in all_q],
                           [a[s0:s0 + ns].view(-1, 1) for a in all_s],
                           g.numel(), g.shape))
        q0, s0 = q0 + nq, s0 + ns
    return out, [r for _, _, _, r in enc]


def compress_allreduce_leaf(g: torch.Tensor, residual: torch.Tensor,
                            axis_name: str) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Error-feedback compressed mean of one leaf over ``axis_name`` of
    the current process mesh. Returns (mean-reduced gradient, new
    residual)."""
    (reduced,), (residual,) = _compressed([g], [residual], axis_name)
    return reduced, residual


def init_residuals(grads) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compressed_psum_tree(grads, residuals, axis_name: str):
    """Apply the EF-int8 all-reduce leaf-wise over ``axis_name``. Returns
    ``(reduced grads, new residuals)``, trees of ``grads``' structure."""
    fg, fr = flatten(grads), flatten(residuals)
    out, new_r = _compressed(list(fg.values()), [fr[k] for k in fg],
                             axis_name)
    red, res = dict(zip(fg, out)), dict(zip(fg, new_r))
    return (map_with_path(lambda k, _: red[k], grads),
            map_with_path(lambda k, _: res[k], grads))


def compression_ratio() -> float:
    """Wire bytes vs fp32: int8 payload + fp32 scale per 256-block."""
    return (BLOCK * 1 + 4) / (BLOCK * 4)
