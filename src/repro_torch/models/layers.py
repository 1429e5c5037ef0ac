"""Shared layers: norms, RoPE, MLPs, embeddings, the loss. Plain functions,
dict params.

The reference's ``shard(...)`` annotations have no counterpart on one GPU
and are left out. Parameters are stored in the config's ``pdtype`` and cast
to the compute dtype at use, as the reference does.

Under the sharded train step a leaf may be this rank's block on ``model``
(``distributed.sharding.computed_on_model``; ``shardlib.model_block``
reads it from the leaf's length): the dense MLP (an MoE layer's shared
expert too) then runs Megatron's split
(``w_gate``/``w_up`` by columns after ``copy_to``, ``w_down`` by rows
before ``reduce_from``), the embedding and the unembedding run over the
rank's vocabulary rows, and the loss is the vocabulary-parallel cross
entropy.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import shardlib


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
        dtype=torch.bfloat16, d_ff: Optional[int] = None) -> torch.Tensor:
    """The (gated) MLP; with ``d_ff``, the width its leaves hold whole,
    tensor-parallel where they are this rank's block of it on ``model``."""
    act = activation(act_fn)
    tp = None if d_ff is None else shardlib.model_block(
        params["w_up"].shape[1], d_ff)
    if tp is not None:
        x = shardlib.copy_to(x, "model", tp[0])
    up = x @ params["w_up"].to(dtype)
    if "w_gate" in params:
        h = act(x @ params["w_gate"].to(dtype)) * up
    else:
        h = act(up)
    if tp is None:
        return h @ params["w_down"].to(dtype)
    return shardlib.row_parallel(h, params["w_down"].to(dtype), tp[0])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen, vocab: int, d_model: int, dtype, device, tie: bool):
    p = {"embedding": embed_init(gen, (vocab, d_model), dtype, device)}
    if not tie:
        p["unembed"] = dense_init(gen, (d_model, vocab), dtype, device)
    return p


def _vocab_block(params, vocab: Optional[int]):
    """(mesh, index) where the vocabulary leaves are this rank's block of
    ``vocab`` rows on ``model``, else None."""
    if vocab is None:
        return None
    rows = params["unembed"].shape[1] if "unembed" in params \
        else params["embedding"].shape[0]
    return shardlib.model_block(rows, vocab)


def embed(params, tokens: torch.Tensor, dtype,
          vocab: Optional[int] = None) -> torch.Tensor:
    """Rows of the table (``vocab`` rows whole); over a block of them, each
    rank's rows where the token is its own, zeros elsewhere, summed."""
    table = params["embedding"]
    tp = None if vocab is None else shardlib.model_block(table.shape[0],
                                                         vocab)
    if tp is None:
        # Gather, then cast: the same values as casting the whole table.
        return table[tokens.long()].to(dtype)
    mesh, r = tp
    n = table.shape[0]
    t = tokens.long() - r * n
    own = (t >= 0) & (t < n)
    rows = table[t.clamp(0, n - 1)].to(dtype)
    rows = torch.where(own[..., None], rows, torch.zeros((), dtype=dtype,
                                                         device=rows.device))
    return shardlib.reduce_from(rows, "model", mesh)


def unembed(params, x: torch.Tensor, dtype,
            vocab: Optional[int] = None) -> torch.Tensor:
    """Logits over the ``vocab`` entries, or over this rank's block of them
    (the input entering through ``copy_to``)."""
    tp = _vocab_block(params, vocab)
    if tp is not None:
        x = shardlib.copy_to(x, "model", tp[0])
    if "unembed" in params:
        w = params["unembed"].to(dtype)
    else:
        w = params["embedding"].to(dtype).T
    return x @ w


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _vocab_parallel(logits: torch.Tensor, labels: torch.Tensor, mesh,
                    index: int):
    """(log-sum-exp, the label's logit) of logits split over ``model`` by
    vocabulary, this rank's block ``index``: the max all-reduced (and
    detached, its gradient cancels), the sum of exponentials and the
    label's logit summed over ``model`` with ``reduce_from``."""
    n = logits.shape[-1]
    top = shardlib.all_reduce_(logits.detach().amax(dim=-1), "model", mesh,
                               op="max")
    total = shardlib.reduce_from(torch.exp(logits - top[..., None]).sum(-1),
                                 "model", mesh)
    t = labels.long() - index * n
    own = (t >= 0) & (t < n)
    ll = torch.gather(logits, -1, t.clamp(0, n - 1)[..., None])[..., 0]
    ll = shardlib.reduce_from(torch.where(own, ll, 0.0), "model", mesh)
    return top + torch.log(total), ll


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          z_weight: float = 1e-4,
                          denom: Optional[torch.Tensor] = None,
                          vocab: Optional[int] = None):
    """Token-mean CE with z-loss; logits (..., V) in any dtype -> fp32.
    Returns ``(ce + z_weight * z, {"ce", "z_loss"})``, both means over the
    masked tokens with denominator ``max(sum(mask), 1)``, or ``denom`` (a
    rank's share of a batch whose mask sums to it across ranks). Logits
    shorter than ``vocab`` are this rank's block of them on ``model``
    (vocabulary-parallel)."""
    logits = logits.float()
    tp = None if vocab is None else shardlib.model_block(logits.shape[-1],
                                                         vocab)
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        lse, ll = _vocab_parallel(logits, labels, *tp)
    ce = lse - ll
    z = lse.square()
    mask = torch.ones_like(ce) if mask is None else mask.float()
    denom = (mask.sum() if denom is None else denom).clamp_min(1.0)
    ce_mean = (ce * mask).sum() / denom
    z_mean = (z * mask).sum() / denom
    return ce_mean + z_weight * z_mean, {"ce": ce_mean, "z_loss": z_mean}
