"""Flash attention forward: causal or windowed GQA attention over a sequence.

``flash_attention(q, k, v, causal=True, window=None)``:

* q: (B, Sq, H, D); k: (B, Sk, KV, D); v: (B, Sk, KV, DV) (DV may differ
  from D, as MLA's value heads do); float32 or bfloat16, all of one dtype;
  H a multiple of KV (query head h reads KV head h // (H // KV)).
* Positions count from 0 in q and in k: key j is visible to query i when
  ``j <= i`` (``causal``) and ``i - j < window`` (``window`` not None).
* Returns (B, Sq, H, DV) in q's dtype: the softmax of the fp32 scores times
  ``D ** -0.5`` over the visible keys, applied to V in fp32. A row with no
  visible key is zeros (the reference's softmax would average V there; with
  Sq == Sk every row sees at least itself).

The wrapper launches ``csrc/flash_attention.cu`` for CUDA tensors, which
takes (D, DV) of :data:`FLASH_SHAPES` (any other pair raises), and runs
:func:`flash_attention_plain` for CPU tensors. ``LAUNCHES_BY_SHAPE``
breaks the kernel's launch count down by (D, DV) and causality, beside
``build.LAUNCHES["flash_attention"]``. ``q_block`` and ``kv_block``
are the TPU kernel's tile sizes; they are accepted for its signature and
not needed: S need not divide by them.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from .build import launch
from .descriptor_copy import stream_of

NEG_INF = -1e30
#: (query/key head dim, value head dim) pairs the CUDA kernel is
#: instantiated for: 96 is phi-3-vision's, 192/128 MLA's.
FLASH_SHAPES = ((64, 64), (96, 96), (128, 128), (192, 128))
#: Kernel launches by shape key (:func:`shape_key`).
LAUNCHES_BY_SHAPE: Counter = Counter()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, window, api: str):
    """Shapes, dtypes and devices the kernel takes; returns the geometry."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{api}: {name} must be a torch.Tensor")
        if t.device != q.device:
            raise ValueError(f"{api}: {name} on {t.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{api}: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{api}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{api}: q, k and v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"{api}: q must be (B, Sq, H, D), k (B, Sk, KV, D) "
                         f"and v (B, Sk, KV, DV), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    bk, sk, kvh, dk = k.shape
    if bk != b or dk != d or kvh < 1 or h % kvh:
        raise ValueError(f"{api}: q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"{api}: window must be >= 1, got {window}")
    return b, sq, h, d, sk, kvh


def _visible(sq: int, sk: int, causal: bool, window: Optional[int],
            device) -> torch.Tensor:
    """(Sq, Sk) bool: which keys each query sees."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kj <= qi
    if window is not None:
        ok &= qi - kj < window
    return ok


def shape_key(d: int, dv: int, causal: bool) -> str:
    """The key of one launch shape in :data:`LAUNCHES_BY_SHAPE`."""
    dims = str(d) if d == dv else f"{d}/{dv}"
    return f"{dims} {'causal' if causal else 'non-causal'}"


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain-PyTorch :func:`flash_attention` (same rules, any D and DV,
    any device): the full fp32 score matrix, one batch element at a time."""
    b, sq, h, d, sk, kvh = _check(q, k, v, window, "flash_attention_plain")
    g, dv = h // kvh, v.shape[-1]
    out = q.new_empty((b, sq, h, dv))
    if sk == 0:
        return out.zero_()
    mask = _visible(sq, sk, causal, window, q.device)
    for bi in range(b):
        qf = q[bi].float().view(sq, kvh, g, d)
        kf, vf = k[bi].float(), v[bi].float()
        s = torch.einsum("qkgd,skd->kgqs", qf, kf) * d ** -0.5
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
        den = p.sum(dim=-1).clamp_min(1e-30)
        o = torch.einsum("kgqs,skd->qkgd", p, vf) / \
            den.permute(2, 0, 1)[..., None]
        out[bi] = o.reshape(sq, h, dv).to(q.dtype)
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_block: int = 128,
                    kv_block: int = 128) -> torch.Tensor:
    """Attention of q over k, v (see the module). ``q_block`` and
    ``kv_block`` are accepted for the TPU kernel's signature only."""
    b, sq, h, d, sk, kvh = _check(q, k, v, window, "flash_attention")
    dv = v.shape[-1]
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if (d, dv) not in FLASH_SHAPES:
        raise ValueError(f"flash_attention: the CUDA kernel takes head dims "
                         f"(D, DV) of {FLASH_SHAPES}, got ({d}, {dv})")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned")
    out = q.new_empty((b, sq, h, dv))
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), b, sq, sk, h, kvh, d, dv, int(causal),
               0 if window is None else int(window), _DTYPE_CODE[q.dtype],
               stream_of(q.device))
    LAUNCHES_BY_SHAPE[shape_key(d, dv, causal)] += 1
    return out
