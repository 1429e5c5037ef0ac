"""Shared layers: norms, RoPE, MLPs, embeddings, the loss. Plain functions,
dict params.

The reference's ``shard(...)`` annotations have no counterpart on one GPU
and are left out. Parameters are stored in the config's ``pdtype`` and cast
to the compute dtype at use, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def dense_init(gen, shape, dtype, device, in_axis: int = 0) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``fan_in ** -0.5``, drawn in fp32
    from ``gen`` (``None`` on the meta device, which draws nothing)."""
    scale = 1.0 / math.sqrt(shape[in_axis])
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out.mul_(scale).to(dtype)


def embed_init(gen, shape, dtype, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def init_rms_norm(dim: int, dtype=torch.float32, device=None):
    # Stored as offset-from-one (gemma convention); rms_norm adds the 1.
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Rotary position embeddings (partial-dim capable)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, rope_fraction: float, theta: float, device):
    rot_dim = int(head_dim * rope_fraction) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=device), exps)
    return inv, rot_dim


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Split halves
    (not interleaved), computed in fp32."""
    head_dim = x.shape[-1]
    inv, rot_dim = rope_freqs(head_dim, fraction, theta, x.device)
    if rot_dim == 0:
        return x
    ang = positions[..., :, None].float() * inv          # (..., seq, rot/2)
    sin = torch.sin(ang)[..., :, None, :]                # broadcast over heads
    cos = torch.cos(ang)[..., :, None, :]
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def activation(act_fn: str):
    """silu, or the tanh-approximated gelu (the reference's gelu)."""
    if act_fn == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def init_mlp(gen, d_model: int, d_ff: int, dtype, device, gated: bool = True):
    p = {}
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype, device)
    p["w_up"] = dense_init(gen, (d_model, d_ff), dtype, device)
    p["w_down"] = dense_init(gen, (d_ff, d_model), dtype, device)
    return p


def mlp(params, x: torch.Tensor, act_fn: str = "silu",
        dtype=torch.bfloat16) -> torch.Tensor:
    act = activation(act_fn)
    up = x @ params["w_up"].to(dtype)
    if "w_gate" in params:
        h = act(x @ params["w_gate"].to(dtype)) * up
    else:
        h = act(up)
    return h @ params["w_down"].to(dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen, vocab: int, d_model: int, dtype, device, tie: bool):
    p = {"embedding": embed_init(gen, (vocab, d_model), dtype, device)}
    if not tie:
        p["unembed"] = dense_init(gen, (d_model, vocab), dtype, device)
    return p


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # Gather, then cast: the same values as casting the whole table first.
    return params["embedding"][tokens.long()].to(dtype)


def unembed(params, x: torch.Tensor, dtype) -> torch.Tensor:
    if "unembed" in params:
        w = params["unembed"].to(dtype)
    else:
        w = params["embedding"].to(dtype).T
    return x @ w


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          z_weight: float = 1e-4,
                          denom: Optional[torch.Tensor] = None):
    """Token-mean CE with z-loss; logits (..., V) in any dtype -> fp32.
    Returns ``(ce + z_weight * z, {"ce", "z_loss"})``, both means over the
    masked tokens with denominator ``max(sum(mask), 1)``, or ``denom`` (a
    rank's share of a batch whose mask sums to it across ranks)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = lse - ll
    z = lse.square()
    mask = torch.ones_like(ce) if mask is None else mask.float()
    denom = (mask.sum() if denom is None else denom).clamp_min(1.0)
    ce_mean = (ce * mask).sum() / denom
    z_mean = (z * mask).sum() / denom
    return ce_mean + z_weight * z_mean, {"ce": ce_mean, "z_loss": z_mean}
