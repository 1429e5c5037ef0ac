"""Flash attention, forward and backward: causal or windowed GQA attention
over a sequence.

``flash_attention(q, k, v, causal=True, window=None, softcap=None)``:

* q: (B, Sq, H, D); k: (B, Sk, KV, D); v: (B, Sk, KV, DV) (DV may differ
  from D, as MLA's value heads do); float32 or bfloat16, all of one dtype;
  H a multiple of KV (query head h reads KV head h // (H // KV)).
* Positions count from 0 in q and in k: key j is visible to query i when
  ``j <= i`` (``causal``) and ``i - j < window`` (``window`` not None).
* Returns (B, Sq, H, DV) in q's dtype: the softmax of the fp32 scores
  ``s = q.k * D ** -0.5`` over the visible keys, applied to V in fp32.
  With a logit ``softcap`` c > 0 the scores are ``c * tanh(s / c)``
  before the mask and the softmax, as the reference's
  ``blockwise_attention`` caps them (D the true head dim). A row with no
  visible key is zeros (the reference's softmax would average V there;
  with Sq == Sk every row sees at least itself), and so are its
  gradients.

The wrapper launches ``csrc/flash_attention.cu`` for CUDA tensors, which
takes (D, DV) of :data:`FLASH_SHAPES` (the reduced configs' 16, 24, 24
over 16 and 32, the published 64, 96, 128, MLA's 192 over 128 and
gemma3-12b's 256, in fp32 and bf16, with or without a cap; MLA's pair
takes none, as MLA passes none; any other pair raises), and runs
:func:`flash_attention_plain` for CPU tensors (and for meta tensors, whose
operations the dry run counts). ``LAUNCHES_BY_SHAPE``
breaks the kernel's launch count down by (D, DV), causality and the cap,
beside ``build.LAUNCHES["flash_attention"]``. ``q_block`` and ``kv_block``
are the TPU kernel's tile sizes; they are accepted for its signature and
not needed: S need not divide by them.

Training: where grad is enabled and q, k or v requires it, the call goes
through :class:`FlashAttentionFn`. Its forward also keeps each row's
log-sum-exp (B, H, Sq) fp32; its backward runs
``csrc/flash_attention_bwd.cu`` (``build.LAUNCHES["flash_attention_bwd"]``)
on the card and :func:`flash_attention_backward_plain` on the CPU, both the
explicit gradient of the same softmax. Without grad (serving) the forward
writes no log-sum-exp. The backward kernel has two designs, chosen by
dtype in :func:`bwd_design` as its launch function chooses them, and
``LAUNCHES_BY_DESIGN`` counts its launches by design.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from .build import DEVICES, launch, plain_device
from .descriptor_copy import stream_of

NEG_INF = -1e30
#: (query/key head dim, value head dim) pairs the CUDA kernel is
#: instantiated for: 16, 24, 24/16 (MLA's reduced) and 32 are the reduced
#: configs', 96 phi-3-vision's, 192/128 MLA's, 256 gemma3-12b's.
FLASH_SHAPES = ((16, 16), (24, 24), (24, 16), (32, 32), (64, 64), (96, 96),
                (128, 128), (192, 128), (256, 256))
#: The pair whose kernels take no logit softcap: MLA's, which passes none.
NO_SOFTCAP_SHAPES = ((192, 128),)
#: Kernel launches by shape key (:func:`shape_key`).
LAUNCHES_BY_SHAPE: Counter = Counter()
#: Backward kernel launches by design (:func:`bwd_design`).
LAUNCHES_BY_DESIGN: Counter = Counter()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, window, api: str, softcap: Optional[float] = None):
    """Shapes, dtypes and devices the kernel takes; returns the geometry."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{api}: {name} must be a torch.Tensor")
        if t.device != q.device:
            raise ValueError(f"{api}: {name} on {t.device}, q on {q.device}")
    if q.device.type not in DEVICES:
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
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{api}: softcap must be > 0, got {softcap}")
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


def shape_key(d: int, dv: int, causal: bool,
              softcap: Optional[float] = None) -> str:
    """The key of one launch shape in :data:`LAUNCHES_BY_SHAPE`."""
    dims = str(d) if d == dv else f"{d}/{dv}"
    key = f"{dims} {'causal' if causal else 'non-causal'}"
    return key if softcap is None else f"{key} softcap"


def _capped(s: torch.Tensor, softcap: Optional[float]):
    """``(capped scores, tanh(s / c))`` of fp32 scores ``s``, the second
    None without a cap."""
    if softcap is None:
        return s, None
    t = torch.tanh(s / softcap)
    return t * softcap, t


def bwd_design(d: int, dv: int, dtype) -> str:
    """Which backward kernels ``csrc/flash_attention_bwd.cu`` launches for
    head dims (D, DV) of :data:`FLASH_SHAPES` in ``dtype``:
    ``"tensor_core"`` (wgmma, TMA) for bf16 at every pair, MLA's (192, 128)
    through a dK/dV kernel of its own whose two warpgroups split each
    (key tile, query tile) pair's products, gemma3-12b's (256, 256)
    through kernels of its own whose warpgroups hold dK and dV apart, the
    reduced configs' 16 to 32 through kernels of their own with boxes as
    wide as the head and tiles of 128 queries and keys;
    ``"cuda_core"`` for fp32, whose tolerance needs exact fp32 sums that
    bf16 products cannot hold."""
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def bwd_scratch_floats(b: int, sq: int, h: int) -> int:
    """fp32 scratch of the backward kernel: each row's Delta and
    log-sum-exp * log2(e), rows padded to a multiple of 128 queries."""
    return 2 * b * h * (-(-sq // 128) * 128)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          return_lse: bool = False):
    """Plain-PyTorch :func:`flash_attention` (same rules, any D and DV,
    any device): the full fp32 score matrix, one batch element at a time.
    With ``return_lse`` also each row's log-sum-exp of the scaled (and
    capped) scores, (B, H, Sq) fp32 (about -1e30 for a row with no visible
    key)."""
    b, sq, h, d, sk, kvh = _check(q, k, v, window, "flash_attention_plain",
                                  softcap)
    g, dv = h // kvh, v.shape[-1]
    out = q.new_empty((b, sq, h, dv))
    lse = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                     device=q.device)
    if sk == 0:
        out.zero_()
        return (out, lse) if return_lse else out
    mask = _visible(sq, sk, causal, window, q.device)
    for bi in range(b):
        qf = q[bi].float().view(sq, kvh, g, d)
        kf, vf = k[bi].float(), v[bi].float()
        s, _ = _capped(torch.einsum("qkgd,skd->kgqs", qf, kf) * d ** -0.5,
                       softcap)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m) * mask
        den = p.sum(dim=-1).clamp_min(1e-30)
        o = torch.einsum("kgqs,skd->qkgd", p, vf) / \
            den.permute(2, 0, 1)[..., None]
        out[bi] = o.reshape(sq, h, dv).to(q.dtype)
        if return_lse:
            lse[bi] = (m[..., 0] + den.log()).reshape(h, sq).detach()
    return (out, lse) if return_lse else out


def flash_attention_backward_plain(q, k, v, out, lse, dout, *,
                                   causal: bool = True,
                                   window: Optional[int] = None,
                                   softcap: Optional[float] = None):
    """Plain-PyTorch gradient of :func:`flash_attention`: ``(dq, dk, dv)``
    in the inputs' dtypes from the forward's ``out`` and ``lse`` and the
    upstream ``dout``. The explicit math, in fp32, one batch element at a
    time: P = exp(S * scale - LSE) on the visible pairs, dP = dO V^T,
    D = rowsum(P * dP) / rowsum(P) (rowsum(dO * O) with O unrounded, as
    rowsum(P) is 1: from the bf16 output it would be off by 2**-9 of
    |dO||O|, and a row of dS must sum to 0), dV = P^T dO, dS = P * (dP - D), dQ = dS K * scale, dK = dS^T Q
    * scale, dK and dV summed over the query heads of each KV head. With a
    ``softcap`` c, S is the capped c tanh(S / c) in P, and dS is further
    multiplied by the cap's derivative (1 - t)(1 + t), t = tanh(S / c),
    as autodiff of the reference's tanh gives it. A row with no visible
    key has P = 0: zero gradients. ``out`` is checked for its shape
    only."""
    b, sq, h, d, sk, kvh = _check(q, k, v, window,
                                  "flash_attention_backward_plain", softcap)
    g, dv_dim = h // kvh, v.shape[-1]
    if out.shape != (b, sq, h, dv_dim) or dout.shape != out.shape \
            or lse.shape != (b, h, sq):
        raise ValueError("flash_attention_backward_plain: out and dout must "
                         f"be {(b, sq, h, dv_dim)} and lse {(b, h, sq)}, got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")
    scale = d ** -0.5
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    if sk and sq:
        mask = _visible(sq, sk, causal, window, q.device)
        for bi in range(b):
            qf = q[bi].float().view(sq, kvh, g, d)
            kf, vf = k[bi].float(), v[bi].float()
            gf = dout[bi].float().view(sq, kvh, g, dv_dim)
            s, t = _capped(torch.einsum("qkgd,skd->kgqs", qf, kf) * scale,
                           softcap)
            row_lse = lse[bi].float().view(kvh, g, sq)[..., None]
            p = torch.where(mask, torch.exp(s - row_lse), 0.0)
            dp = torch.einsum("qkgd,skd->kgqs", gf, vf)
            delta = (p * dp).sum(-1, keepdim=True) \
                / p.sum(-1, keepdim=True).clamp_min(1e-30)
            ds = p * (dp - delta)
            if t is not None:
                ds = ds * ((1 - t) * (1 + t))
            dv[bi] = torch.einsum("kgqs,qkgd->skd", p, gf)
            dk[bi] = torch.einsum("kgqs,qkgd->skd", ds, qf) * scale
            dq[bi] = (torch.einsum("kgqs,skd->qkgd", ds, kf)
                      * scale).reshape(sq, h, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_inputs(api: str, d: int, dv: int, softcap: Optional[float],
                   *tensors) -> None:
    """What the CUDA kernels take beyond :func:`_check`."""
    if (d, dv) not in FLASH_SHAPES:
        raise ValueError(f"{api}: the CUDA kernel takes head dims "
                         f"(D, DV) of {FLASH_SHAPES}, got ({d}, {dv})")
    if softcap is not None and (d, dv) in NO_SOFTCAP_SHAPES:
        raise ValueError(f"{api}: the CUDA kernel takes no softcap at head "
                         f"dims ({d}, {dv})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{api}: every input must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{api}: every input must be 16-byte aligned")


def _cap_arg(softcap: Optional[float]) -> float:
    """The launch functions' softcap: 0 for none."""
    return 0.0 if softcap is None else float(softcap)

def _forward(q, k, v, causal: bool, window: Optional[int],
             with_lse: bool, softcap: Optional[float] = None):
    """``(out, lse)`` of the forward, ``lse`` None unless ``with_lse``:
    the kernel on the card, the plain version on the CPU (or meta)."""
    b, sq, h, d, sk, kvh = _check(q, k, v, window, "flash_attention",
                                  softcap)
    dv = v.shape[-1]
    if plain_device(q):
        if with_lse:
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window, softcap=softcap,
                                         return_lse=True)
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap), None
    _kernel_inputs("flash_attention", d, dv, softcap, q, k, v)
    out = q.new_empty((b, sq, h, dv))
    lse = None
    if with_lse:   # every row is written by the kernel when there are keys
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        if sk == 0:
            lse.fill_(NEG_INF)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), None if lse is None else lse.data_ptr(),
               b, sq, sk, h, kvh, d, dv, int(causal),
               0 if window is None else int(window), _DTYPE_CODE[q.dtype],
               _cap_arg(softcap), stream_of(q.device))
    LAUNCHES_BY_SHAPE[shape_key(d, dv, causal, softcap)] += 1
    return out, lse



def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None):
    """``(dq, dk, dv)`` of :func:`flash_attention`: the backward kernel for
    CUDA tensors, :func:`flash_attention_backward_plain` for CPU tensors.
    Deterministic on the card: two calls on the same inputs agree bit for
    bit."""
    b, sq, h, d, sk, kvh = _check(q, k, v, window,
                                  "flash_attention_backward", softcap)
    if plain_device(q):
        return flash_attention_backward_plain(q, k, v, out, lse, dout,
                                              causal=causal, window=window,
                                              softcap=softcap)
    dv_dim = v.shape[-1]
    if out.shape != (b, sq, h, dv_dim) or dout.shape != out.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("flash_attention_backward: out and dout must be "
                         f"{(b, sq, h, dv_dim)} in {q.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_backward: lse must be "
                         f"{(b, h, sq)} float32")
    _kernel_inputs("flash_attention_backward", d, dv_dim, softcap, q, k, v,
                   out, dout, lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if dq.numel() + dk.numel() + dv.numel() == 0:
        return dq, dk, dv
    scratch = torch.empty(bwd_scratch_floats(b, sq, h), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        launch("flash_attention_bwd", q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
               scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
               dv.data_ptr(), b, sq, sk, h, kvh, d, dv_dim, int(causal),
               0 if window is None else int(window), _DTYPE_CODE[q.dtype],
               _cap_arg(softcap), stream_of(q.device))
    LAUNCHES_BY_DESIGN[bwd_design(d, dv_dim, q.dtype)] += 1
    return dq, dk, dv



class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with its gradient: the forward keeps ``out``
    and the log-sum-exp, the backward is :func:`flash_attention_backward`
    (the kernel on the card, the plain math on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                softcap: Optional[float] = None):
        out, lse = _forward(q, k, v, causal, window, with_lse=True,
                            softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # The kernels take contiguous tensors. The model's output projection
        # hands dout over contiguous (on the card as on the CPU), so this
        # copies nothing there; another caller's strided dout is copied.
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
            window=ctx.window, softcap=ctx.softcap)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, q_block: int = 128,
                    kv_block: int = 128) -> torch.Tensor:
    """Attention of q over k, v (see the module). ``q_block`` and
    ``kv_block`` are accepted for the TPU kernel's signature only."""
    _check(q, k, v, window, "flash_attention", softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, with_lse=False,
                    softcap=softcap)[0]
