"""Attention: GQA/MHA with q/k-norm, partial RoPE and sliding windows.

Train/prefill attention runs the core through
:func:`repro_torch.kernels.ops.flash_attention_op`: the hand-written CUDA
flash kernel on the card, its plain version on the CPU. The kernel takes
positions that count from 0 (what ``model.forward`` builds), no logit
softcap, and head dims 64 or 128. Anything else runs
:func:`blockwise_attention` (the flash schedule in plain PyTorch) on the
CPU and raises ``NotImplementedError`` on the card: nothing on the card
gives way quietly to a plain version.

Decode attends one new token per row against a dense-view cache with
per-slot position tags (:class:`KVCacheView`): slot = pos % cache_len, so
full caches, sliding windows and ring buffers share one masking rule. The
reference's decode is jnp over that view, not a Pallas kernel, and so is
the port's. Where the reference rebuilds the cache functionally
(``.at[].set``), the port writes the new token's K/V and tag into the
cache in place: a cache is allocated once and lives as long as its state.

MLA is the reference's and waits for ROADMAP Queue A item 14.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import FLASH_HEAD_DIMS
from .layers import apply_rope, dense_init, init_rms_norm, rms_norm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

_MLA_GAP = "MLA attention is not ported yet (ROADMAP Queue A item 14)"


def init_attention(gen, cfg: ModelConfig, device):
    if cfg.mla is not None:
        raise NotImplementedError(_MLA_GAP)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    dt = cfg.pdtype
    p = {
        "wq": dense_init(gen, (d, h, hd), dt, device),
        "wk": dense_init(gen, (d, kv, hd), dt, device),
        "wv": dense_init(gen, (d, kv, hd), dt, device),
        "wo": dense_init(gen, (h, hd, d), dt, device, in_axis=0),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, dt, device)
        p["k_norm"] = init_rms_norm(hd, dt, device)
    return p


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention — the plain schedule
# ---------------------------------------------------------------------------

def _mask(q_pos, kv_pos, causal: bool, window: Optional[int]):
    """q_pos: (..., Sq), kv_pos: (..., Sk) -> (..., Sq, Sk) additive mask."""
    ok = kv_pos[..., None, :] >= 0
    if causal:
        ok = ok & (kv_pos[..., None, :] <= q_pos[..., :, None])
    if window is not None:
        ok = ok & (q_pos[..., :, None] - kv_pos[..., None, :] < window)
    return torch.where(ok, 0.0, NEG_INF)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        q_positions: Optional[torch.Tensor] = None,
                        kv_positions: Optional[torch.Tensor] = None,
                        softcap: Optional[float] = None,
                        q_block: int = 512,
                        kv_block: int = 512) -> torch.Tensor:
    """Memory-efficient attention: an outer loop over q blocks, an inner one
    over kv blocks with running (max, sum, acc) — the flash schedule.

    q: (B, Sq, H, D); k: (B, Sk, KV, D); v: (B, Sk, KV, Dv) (Dv may differ).
    """
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    dv = v.shape[-1]
    g = h // kv
    scale = d ** -0.5
    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    if sq % q_block or sk % kv_block:
        raise ValueError(f"blocks ({q_block}, {kv_block}) must divide "
                         f"({sq}, {sk})")
    nq, nk = sq // q_block, sk // kv_block
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(sq, dtype=torch.int32,
                                   device=dev).expand(b, sq)
    if kv_positions is None:
        kv_positions = torch.arange(sk, dtype=torch.int32,
                                    device=dev).expand(b, sk)

    qb = q.reshape(b, nq, q_block, kv, g, d)
    kb = k.reshape(b, nk, kv_block, kv, d)
    vb = v.reshape(b, nk, kv_block, kv, dv)
    qpb = q_positions.reshape(b, nq, q_block)
    kpb = kv_positions.reshape(b, nk, kv_block)

    outs = []
    for qi in range(nq):
        qi_q = qb[:, qi].float()                      # (B, qb, KV, G, D)
        qi_pos = qpb[:, qi]
        m_run = torch.full((b, kv, g, q_block), NEG_INF, device=dev)
        l_run = torch.zeros((b, kv, g, q_block), device=dev)
        acc = torch.zeros((b, kv, g, q_block, dv), device=dev)
        for ki in range(nk):
            kk, vv, kpos = kb[:, ki], vb[:, ki], kpb[:, ki]
            s = torch.einsum("bqkgd,bskd->bkgqs", qi_q, kk.float()) * scale
            if softcap is not None:
                s = torch.tanh(s / softcap) * softcap
            s = s + _mask(qi_pos, kpos, causal, window)[:, None, None]
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vv.dtype).float(), vv.float())
            m_run = m_new
        out = acc / l_run.clamp_min(1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_block, h, dv))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Full-pass (train / prefill) attention layers
# ---------------------------------------------------------------------------

class KVCacheView(NamedTuple):
    """Dense-view cache for one layer: position-tagged slots."""
    k: torch.Tensor          # (B, S, KV, D)
    v: torch.Tensor          # (B, S, KV, D)
    kv_pos: torch.Tensor     # (B, S) int32, -1 = empty


def _project_qkv(params, x, cfg: ModelConfig, positions):
    dt = cfg.cdtype
    b, s, dm = x.shape

    def proj(w):             # "bsd,dhe->bshe"
        return (x @ w.to(dt).reshape(dm, -1)).view(b, s, *w.shape[1:])

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"]["scale"], cfg.norm_eps)
    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)
    return q, k, v.contiguous()


def _counts_from_zero(positions: torch.Tensor) -> bool:
    """Whether every row of positions (B, S) is 0, 1, ..., S - 1."""
    ar = torch.arange(positions.shape[-1], device=positions.device)
    return bool(torch.equal(positions.long(), ar.expand_as(positions)))


def _kernel_gap(cfg: ModelConfig, positions, head_dim: int) -> Optional[str]:
    """What keeps the flash kernel from this call on the card, or None."""
    if cfg.attn_logit_softcap is not None:
        return "a logit softcap in the flash kernel"
    if not _counts_from_zero(positions):
        return "positions that do not count from 0 in the flash kernel"
    if head_dim not in FLASH_HEAD_DIMS:
        return f"head dim {head_dim} in the flash kernel"
    return None


def attention(params, x, positions, cfg: ModelConfig, *,
              kind: str = "attn", causal: bool = True,
              return_cache: bool = False):
    """Full-sequence attention. kind: 'attn' (full) or 'local' (windowed)."""
    if cfg.mla is not None:
        raise NotImplementedError(_MLA_GAP)
    if cfg.attention_impl != "blockwise":
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} is not ported")
    dt = cfg.cdtype
    q, k, v = _project_qkv(params, x, cfg, positions)
    window = cfg.sliding_window if kind == "local" else None
    gap = _kernel_gap(cfg, positions, cfg.head_dim_)
    cpu = x.device.type == "cpu"
    if gap is None or (cpu and gap.startswith("head dim")):
        # On the CPU the op runs the plain version, which takes any D.
        out = ops.flash_attention_op(q, k, v, causal=causal, window=window)
    elif cpu:
        out = blockwise_attention(q, k, v, causal=causal, window=window,
                                  q_positions=positions,
                                  kv_positions=positions,
                                  softcap=cfg.attn_logit_softcap)
    else:
        raise NotImplementedError(f"attention on the card needs {gap}, "
                                  "which is not ported")
    b, s = x.shape[:2]
    y = out.reshape(b, s, -1) @ params["wo"].to(dt).reshape(-1, x.shape[-1])
    if return_cache:
        return y, KVCacheView(k, v, positions.to(torch.int32))
    return y


# ---------------------------------------------------------------------------
# Decode (single-token) attention against a dense-view cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, kind: str,
               device=None) -> KVCacheView:
    """An empty cache for one layer in the compute dtype: zeros, every tag
    -1. A ``local`` layer keeps ``min(max_len, sliding_window)`` slots."""
    if cfg.mla is not None:
        raise NotImplementedError(_MLA_GAP)
    size = min(max_len, cfg.sliding_window) if (
        kind == "local" and cfg.sliding_window) else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim_)
    return KVCacheView(
        k=torch.zeros(shape, dtype=cfg.cdtype, device=device),
        v=torch.zeros(shape, dtype=cfg.cdtype, device=device),
        kv_pos=torch.full((batch, size), -1, dtype=torch.int32,
                          device=device))


def decode_attention(params, x, cache: KVCacheView, cur_pos,
                     cfg: ModelConfig, *, kind: str = "attn"
                     ) -> Tuple[torch.Tensor, KVCacheView]:
    """One decode step. x: (B, 1, d_model); cur_pos: (B,) current position.

    Writes the step's K/V and tag into ``cache`` in place, at slot
    ``cur_pos % cache_len``, then attends over every slot whose tag the
    mask admits. Returns ``(y, cache)``, the cache being the same tensors.
    """
    if cfg.mla is not None:
        raise NotImplementedError(_MLA_GAP)
    dt = cfg.cdtype
    b = x.shape[0]
    kv, g, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim_
    positions = cur_pos[:, None]
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)

    slot = (cur_pos % cache.k.shape[1]).long()
    bidx = torch.arange(b, device=x.device)
    cache.k[bidx, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[bidx, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.kv_pos[bidx, slot] = cur_pos.to(torch.int32)

    window = cfg.sliding_window if kind == "local" else None
    # Scores in fp32 from the bf16 operands (the reference's
    # preferred_element_type=float32).
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     q.reshape(b, 1, kv, g, hd).float(),
                     cache.k.float()) * hd ** -0.5
    if cfg.attn_logit_softcap:
        s = torch.tanh(s / cfg.attn_logit_softcap) * cfg.attn_logit_softcap
    s = s + _mask(positions, cache.kv_pos, True, window)[:, None, None]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(dt), cache.v.to(dt))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, kv * g * hd)
    y = out @ params["wo"].to(dt).reshape(-1, x.shape[-1])
    return y, cache
