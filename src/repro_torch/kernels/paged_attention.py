"""Paged decode attention over the KV pages the DMA runtime moves.

``paged_attention(q, k_pages, v_pages, block_tables, lengths)``: each
sequence's KV cache is a chain of fixed-size pages (one page = one
descriptor, §II-B) in a shared pool; its row of ``block_tables`` names the
physical pages in order, and ``lengths`` counts its tokens. One query token
per sequence attends over them.

* q: (B, H, D); k_pages, v_pages: (P, page, KV, D), float32 or bfloat16,
  all of one dtype; H a multiple of KV with H / KV <= 8 (GQA), D a
  multiple of 4 up to 256.
* block_tables: (B, max_pages) int32, -1 for no page; lengths: (B,) int32.
  Both on the pools' device (:meth:`PagedKVCache.kernel_args` gives them
  so). Entries must be < P.
* Returns (B, H, D) in q's dtype: the softmax over the valid tokens (pages
  ``p < ceil(len / page)`` whose entry is >= 0, positions ``< len``),
  computed in fp32. A row with no valid token is zeros, as the TPU kernel
  gives (its reference averages V there instead).

The wrapper launches ``csrc/paged_attention.cu`` for CUDA tensors (or
raises) and runs :func:`paged_attention_plain` for CPU tensors.
"""
from __future__ import annotations

import torch

from .build import launch, refuse_grad
from .descriptor_copy import stream_of

NEG_INF = -1e30
MAX_GROUP = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k_pages, v_pages, block_tables, lengths, api: str):
    """Shapes, dtypes and devices the kernel takes; returns the geometry."""
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{api}: {name} must be a torch.Tensor")
        if t.device != q.device:
            raise ValueError(f"{api}: {name} on {t.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{api}: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{api}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"{api}: q, k_pages and v_pages must share a dtype, "
                        f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    for name, t in (("block_tables", block_tables), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"{api}: {name} must be int32, got {t.dtype}")
    if q.ndim != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{api}: q must be (B, H, D) and k_pages, v_pages "
                         "(P, page, KV, D) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    b, h, d = q.shape
    _, page, kvh, dk = k_pages.shape
    if dk != d or kvh < 1 or h % kvh:
        raise ValueError(f"{api}: q (B, {h}, {d}) does not fit pages with "
                         f"{kvh} KV heads of dim {dk}")
    if h // kvh > MAX_GROUP:
        raise ValueError(f"{api}: {h // kvh} query heads per KV head; at "
                         f"most {MAX_GROUP}")
    if d % 4 or not 0 < d <= 256:
        raise ValueError(f"{api}: head dim {d} must be a multiple of 4 "
                         "up to 256")
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError(f"{api}: block_tables must be (B, max_pages) and "
                         f"lengths (B,) for B = {b}, got "
                         f"{tuple(block_tables.shape)}, "
                         f"{tuple(lengths.shape)}")
    return b, h, d, page, kvh


def paged_attention_plain(q, k_pages, v_pages, block_tables,
                          lengths) -> torch.Tensor:
    """Plain-PyTorch :func:`paged_attention` (same rules, any device)."""
    b, h, d, page, kvh = _check(q, k_pages, v_pages, block_tables, lengths,
                                "paged_attention_plain")
    g = h // kvh
    max_pages = block_tables.shape[1]
    if max_pages == 0:
        return torch.zeros_like(q)
    tables = block_tables.long()
    safe = tables.clamp_min(0)
    k = k_pages[safe].reshape(b, max_pages * page, kvh, d).float()
    v = v_pages[safe].reshape(b, max_pages * page, kvh, d).float()
    pos = torch.arange(max_pages * page, device=q.device)
    valid = (pos[None, :] < lengths.long()[:, None]) \
        & (tables >= 0).repeat_interleave(page, dim=1)
    qg = q.reshape(b, kvh, g, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * d ** -0.5
    mask = valid[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    den = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p, v) / den[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention(q, k_pages, v_pages, block_tables,
                    lengths) -> torch.Tensor:
    """Decode attention of q over its sequence's pages (see the module)."""
    b, h, d, page, kvh = _check(q, k_pages, v_pages, block_tables, lengths,
                                "paged_attention")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     lengths)
    refuse_grad("paged_attention", q, k_pages, v_pages)
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: every input must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention: q and the pools must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if b == 0:
        return out
    with torch.cuda.device(q.device):
        launch("paged_attention", q.data_ptr(), k_pages.data_ptr(),
               v_pages.data_ptr(), block_tables.data_ptr(),
               lengths.data_ptr(), out.data_ptr(), b, kvh, h // kvh, d, page,
               block_tables.shape[1], _DTYPE_CODE[q.dtype],
               stream_of(q.device))
    return out
