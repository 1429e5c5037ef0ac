"""Mamba-2 (SSD: state-space duality, arXiv:2405.21060) layer.

Chunked SSD algorithm: within-chunk terms are attention-like einsums
(parallel over chunks), the cross-chunk recurrence is a short Python loop
over chunk states (the reference's ``lax.scan``), giving O(S * Q) work with
Q = chunk length instead of O(S^2), and an O(1)-state decode step.

The reference has no Pallas kernel here: its SSD is jnp, and this plain
PyTorch on the card is the port of it, not a fallback. ``A_log``, ``D`` and
``dt_bias`` stay fp32 whatever the parameter dtype, and so does the SSD
state (the chunk states, the recurrence and the decode cache's ``state``);
the convolution's rolling inputs are kept in the compute dtype.

Layout: d_inner = expand * d_model channels split into H = d_inner/P heads of
dim P; B/C projections have G groups of state size N shared across heads.
``mamba_decode`` writes its cache in place, as the attention caches are.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import dense_init, rms_norm


class MambaCache(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, conv_channels) rolling conv inputs
    state: torch.Tensor   # (B, H, N, P) SSD state, fp32


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_ch


def init_mamba(gen, cfg: ModelConfig, device):
    s = cfg.ssm
    d_inner, n_heads, conv_ch = _dims(cfg)
    in_proj = dense_init(gen, (cfg.d_model, 2 * d_inner
                               + 2 * s.n_groups * s.d_state + n_heads),
                         cfg.pdtype, device)
    conv_w = dense_init(gen, (s.d_conv, conv_ch), cfg.pdtype, device)
    # dt bias initialised so softplus(dt_bias) spans [dt_min, dt_max].
    u = torch.rand((n_heads,), generator=gen, device=device)
    lo, hi = math.log(s.dt_min), math.log(s.dt_max)
    dt0 = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))        # inverse softplus
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=cfg.pdtype, device=device),
        "dt_bias": dt_bias.float(),
        "A_log": torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=device),
        "norm": {"scale": torch.zeros((d_inner,), dtype=cfg.pdtype,
                                      device=device)},
        "out_proj": dense_init(gen, (d_inner, cfg.d_model), cfg.pdtype,
                               device),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int,
                     device=None) -> MambaCache:
    """An empty decode cache for one layer: conv inputs in the compute
    dtype, the SSD state in fp32, all zeros."""
    s = cfg.ssm
    d_inner, n_heads, conv_ch = _dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=cfg.cdtype,
                         device=device),
        state=torch.zeros((batch, n_heads, s.d_state, s.head_dim),
                          dtype=torch.float32, device=device))


def _split_proj(params, x, cfg: ModelConfig):
    d_inner, _, conv_ch = _dims(cfg)
    proj = x @ params["in_proj"].to(cfg.cdtype)
    # split points: z | xBC | dt
    return (proj[..., :d_inner], proj[..., d_inner:d_inner + conv_ch],
            proj[..., d_inner + conv_ch:])


def _causal_conv(xbc, conv_w, conv_b, prev=None):
    """Depthwise causal conv along seq. xbc: (B, S, C); prev: (B, K-1, C)."""
    k = conv_w.shape[0]
    if prev is None:
        prev = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    padded = torch.cat([prev, xbc], dim=1)
    out = padded[:, :xbc.shape[1]] * conv_w[0]
    for i in range(1, k):
        out = out + padded[:, i:i + xbc.shape[1]] * conv_w[i]
    new_prev = padded[:, -(k - 1):] if k > 1 else prev
    return F.silu(out + conv_b), new_prev


def _heads(xbc, cfg: ModelConfig, lead):
    """x (..., H, P), B and C (..., H, N) in fp32 from the conv output,
    each B/C group repeated over its heads."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    g, n = s.n_groups, s.d_state
    hpg = n_heads // g
    xc = xbc[..., :d_inner].reshape(*lead, n_heads, s.head_dim).float()
    bm = xbc[..., d_inner:d_inner + g * n].reshape(*lead, g, n).float()
    cm = xbc[..., d_inner + g * n:].reshape(*lead, g, n).float()
    return (xc, bm.repeat_interleave(hpg, dim=-2),
            cm.repeat_interleave(hpg, dim=-2))


def _gate_out(params, y, z, cfg: ModelConfig):
    """Gate y (fp32) by silu(z), normalise and project out."""
    dt_c = cfg.cdtype
    y = y * F.silu(z.float())
    y = rms_norm(y.to(dt_c), params["norm"]["scale"], cfg.norm_eps)
    return y @ params["out_proj"].to(dt_c)


def mamba_layer(params, x: torch.Tensor, cfg: ModelConfig, *,
                return_cache: bool = False):
    """Full-sequence SSD pass. x: (B, S, d_model)."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    b, seqlen, _ = x.shape
    q = min(s.chunk, seqlen)
    if seqlen % q:
        raise ValueError(f"seq {seqlen} not divisible by chunk {q}")
    nc = seqlen // q
    dt_c = cfg.cdtype

    z, xbc, dt_raw = _split_proj(params, x, cfg)
    xbc, conv_tail = _causal_conv(xbc, params["conv_w"].to(dt_c),
                                  params["conv_b"].to(dt_c))
    xc, bh, ch = _heads(xbc, cfg, (b, nc, q))           # (B,nc,Q,H,P|N)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (B,S,H)
    dt = dt.reshape(b, nc, q, n_heads)
    a = -torch.exp(params["A_log"])                       # (H,) negative
    cum = torch.cumsum(dt * a, dim=2)                     # (B,nc,Q,H)

    # Intra-chunk (attention-like): L[i, j] = exp(cum_i - cum_j) for j <= i.
    idx = torch.arange(q, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    ld = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Qi,Qj,H)
    el = torch.exp(ld.masked_fill(~causal, -math.inf))
    del ld
    cb = torch.einsum("bcihn,bcjhn->bcijh", ch, bh)
    m = cb * el * dt[:, :, None, :, :]
    del cb, el
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xc)
    del m

    # Chunk states, then the cross-chunk recurrence over nc chunks.
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt           # (B,nc,Q,H)
    s_chunk = torch.einsum("bcqhn,bcqhp->bchnp", bh * w[..., None], xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B,nc,H)
    h = xc.new_zeros((b, n_heads, s.d_state, s.head_dim))
    states = []
    for c in range(nc):
        states.append(h)
        h = h * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_states = torch.stack(states, dim=1)                 # (B,nc,H,N,P)

    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", ch, h_states) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter + params["D"][:, None] * xc).reshape(
        b, seqlen, d_inner)
    out = _gate_out(params, y, z, cfg)
    if return_cache:
        return out, MambaCache(conv=conv_tail, state=h)
    return out


def mamba_decode(params, x: torch.Tensor, cache: MambaCache,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, MambaCache]:
    """One-token recurrent step. x: (B, 1, d_model).

    Writes the new conv inputs and state into ``cache`` in place and
    returns ``(y, cache)``, the cache being the same tensors."""
    d_inner, n_heads, _ = _dims(cfg)
    b = x.shape[0]
    dt_c = cfg.cdtype

    z, xbc, dt_raw = _split_proj(params, x, cfg)
    xbc, conv_tail = _causal_conv(xbc, params["conv_w"].to(dt_c),
                                  params["conv_b"].to(dt_c),
                                  prev=cache.conv.to(dt_c))
    xc, bh, ch = _heads(xbc[:, 0], cfg, (b,))            # (B,H,P|N)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])   # (B,H)
    decay = torch.exp(dt * -torch.exp(params["A_log"]))

    state = cache.state * decay[..., None, None] \
        + torch.einsum("bhn,bhp->bhnp", bh * dt[..., None], xc)
    y = torch.einsum("bhn,bhnp->bhp", ch, state) + params["D"][:, None] * xc
    out = _gate_out(params, y.reshape(b, 1, d_inner), z, cfg)
    cache.conv.copy_(conv_tail)
    cache.state.copy_(state)
    return out, cache
