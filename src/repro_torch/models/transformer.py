"""Layer-stack assembly: heterogeneous block *periods*, run as a Python loop.

A model is ``first_k_dense`` prefix layers plus N identical *periods*; each
period is the config's ``block_pattern``. The reference stacks each
pattern slot's parameters over periods and scans; the port keeps one
parameter dict per (slot, period) (``params["slots"][j][i]``) and loops.
This slice is inference: no remat. Decode caches keep the reference's
layout (a ``KVCacheView`` per prefix layer, one per pattern slot stacked
over periods); ``stack_decode`` updates them in place through per-period
views. Mamba mixers and cross-attention are the reference's and wait for
ROADMAP Queue A item 14.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from .attention import (
    KVCacheView,
    attention,
    decode_attention,
    init_attention,
    init_cache,
)
from .layers import init_mlp, init_rms_norm, mlp, rms_norm
from .moe import init_moe, moe_ffn


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def _check_mixer(mixer: str) -> None:
    if mixer not in ("attn", "local"):
        raise NotImplementedError(f"{mixer!r} mixers are not ported yet "
                                  "(ROADMAP Queue A item 14)")


def init_block(gen, cfg: ModelConfig, mixer: str, ffn: str, device):
    _check_mixer(mixer)
    p: dict = {"norm1": init_rms_norm(cfg.d_model, cfg.pdtype, device),
               "norm2": init_rms_norm(cfg.d_model, cfg.pdtype, device),
               "mixer": init_attention(gen, cfg, device)}
    if ffn == "moe":
        p["ffn"] = init_moe(gen, cfg, device)
    elif ffn == "dense":
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, device,
                            gated=cfg.mlp_gated)
    # ffn == "none": no FFN params, norm2 unused.
    return p


def block_forward(p, x, positions, cfg: ModelConfig, mixer: str, ffn: str,
                  *, causal: bool = True, return_cache: bool = False):
    """Pre-norm block. Returns (x, aux_loss, cache|None)."""
    _check_mixer(mixer)
    h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    cache = None
    out = attention(p["mixer"], h, positions, cfg, kind=mixer, causal=causal,
                    return_cache=return_cache)
    if return_cache:
        out, cache = out
    x = x + out

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "none":
        return x, aux, cache
    h2 = rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
    if ffn == "moe":
        y, aux, _ = moe_ffn(p["ffn"], h2, cfg, cfg.act_fn)
    else:
        y = mlp(p["ffn"], h2, cfg.act_fn, cfg.cdtype)
    return x + y, aux, cache


# ---------------------------------------------------------------------------
# Stack: prefix layers + periods
# ---------------------------------------------------------------------------

def n_periods(cfg: ModelConfig) -> int:
    n = cfg.num_layers - cfg.first_k_dense
    if n % len(cfg.block_pattern):
        raise ValueError(f"{cfg.name}: {n} layers after the dense prefix "
                         f"do not divide into periods of "
                         f"{len(cfg.block_pattern)}")
    return n // len(cfg.block_pattern)


def init_stack(gen, cfg: ModelConfig, device):
    """{"prefix": [block, ...], "slots": ([block per period], ...)}: one
    parameter dict per layer, in the reference's layer order."""
    pattern = cfg.block_pattern
    periods = n_periods(cfg)
    prefix = [init_block(gen, cfg, pattern[0][0], "dense", device)
              for _ in range(cfg.first_k_dense)]
    slots = tuple([] for _ in pattern)
    for _ in range(periods):
        for j, (mixer, ffn) in enumerate(pattern):
            slots[j].append(init_block(gen, cfg, mixer, ffn, device))
    return {"prefix": prefix, "slots": slots}


def _stack_caches(caches):
    """Per-period KVCacheViews of one slot, stacked on a leading period
    axis as the reference's scan returns them."""
    return KVCacheView(*(torch.stack(parts) for parts in zip(*caches)))


def stack_forward(params, x, positions, cfg: ModelConfig, *,
                  return_caches: bool = False):
    """Full-sequence pass. Returns (x, aux_loss, caches).

    caches: {"prefix": [...], "slots": tuple per slot, stacked over periods}
    """
    pattern = cfg.block_pattern
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    prefix_caches = []
    for p in params["prefix"]:
        x, aux, c = block_forward(p, x, positions, cfg, pattern[0][0], "dense",
                                  return_cache=return_caches)
        aux_total = aux_total + aux
        prefix_caches.append(c)

    slot_caches = tuple([] for _ in pattern)
    for i in range(len(params["slots"][0])):
        for j, (mixer, ffn) in enumerate(pattern):
            x, aux, c = block_forward(params["slots"][j][i], x, positions,
                                      cfg, mixer, ffn,
                                      return_cache=return_caches)
            aux_total = aux_total + aux
            slot_caches[j].append(c)
    caches: Optional[dict] = None
    if return_caches:
        caches = {"prefix": prefix_caches,
                  "slots": tuple(_stack_caches(c) for c in slot_caches)}
    return x, aux_total, caches


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------

def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device=None):
    """Empty caches for the decoder stack: ``{"prefix": [KVCacheView, ...],
    "slots": (KVCacheView stacked over periods, ...)}``."""
    if cfg.is_encdec:
        raise NotImplementedError("cross-attention caches are not ported "
                                  "yet (ROADMAP Queue A item 14)")
    pattern = cfg.block_pattern
    for mixer, _ in pattern:
        _check_mixer(mixer)
    periods = n_periods(cfg)
    prefix = [init_cache(cfg, batch, max_len, pattern[0][0], device)
              for _ in range(cfg.first_k_dense)]
    slots = []
    for mixer, _ in pattern:
        one = init_cache(cfg, batch, max_len, mixer, device)
        slots.append(KVCacheView(*(x.unsqueeze(0).repeat(
            (periods,) + (1,) * x.ndim) for x in one)))
    return {"prefix": prefix, "slots": tuple(slots)}


def _period_view(cache: KVCacheView, i: int) -> KVCacheView:
    """Period i of a stacked cache: views, so writes land in the stack."""
    return KVCacheView(cache.k[i], cache.v[i], cache.kv_pos[i])


def stack_decode(params, x, caches, cur_pos, cfg: ModelConfig):
    """One-token decode through the stack. x: (B, 1, d).

    Returns ``(x, caches)``; the caches are updated in place and returned
    as the same objects.
    """
    pattern = cfg.block_pattern

    def block_step(p, x, cache, mixer, ffn):
        _check_mixer(mixer)
        h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
        out, _ = decode_attention(p["mixer"], h, cache, cur_pos, cfg,
                                  kind=mixer)
        x = x + out
        if ffn == "none":
            return x
        h2 = rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
        if ffn == "moe":
            y, _, _ = moe_ffn(p["ffn"], h2, cfg, cfg.act_fn)
        else:
            y = mlp(p["ffn"], h2, cfg.act_fn, cfg.cdtype)
        return x + y

    for p, cache in zip(params["prefix"], caches["prefix"]):
        x = block_step(p, x, cache, pattern[0][0], "dense")
    for i in range(len(params["slots"][0])):
        for j, (mixer, ffn) in enumerate(pattern):
            x = block_step(params["slots"][j][i], x,
                           _period_view(caches["slots"][j], i), mixer, ffn)
    return x, caches
