"""Top-level model: embeddings -> stack -> head; prefill and decode.

``init_params`` draws the weights on the card (or ``device``) from a seeded
``torch.Generator``; :func:`repro_torch.models.convert.params_from_jax`
turns the reference's own weights into the same structure.
``forward`` is the decoder-only prefill pass with the reference's return
value. ``prefill`` runs it and lays its K/V into position-tagged decode
caches; ``decode_step`` advances every row by one token, writing the
caches in place. The multimodal prefix, the encoder and ``loss_fn`` are
the reference's and wait for ROADMAP Queue A items 14 and 15.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from .layers import embed, init_embed, init_rms_norm, rms_norm, unembed
from .transformer import (
    init_decode_caches,
    init_stack,
    stack_decode,
    stack_forward,
)


class DecodeState(NamedTuple):
    caches: Any
    cur_pos: torch.Tensor      # (B,) int32: the next position to write


def _init(gen, cfg: ModelConfig, device) -> Dict:
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models are not ported yet")
    return {
        "embed": init_embed(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype,
                            device, cfg.tie_embeddings),
        "stack": init_stack(gen, cfg, device),
        "final_norm": init_rms_norm(cfg.d_model, cfg.pdtype, device),
    }


def init_params(seed, cfg: ModelConfig, device=None) -> Dict:
    """Random weights for ``cfg``, drawn from ``seed`` (an int, or a
    ``torch.Generator`` on ``device``) in the reference's distributions.
    ``device`` defaults to ``cuda``."""
    dev = resolve_device(device)
    gen = seed
    if not isinstance(seed, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    return _init(gen, cfg, dev)


def param_shapes(cfg: ModelConfig) -> Dict:
    """Shape-only init: the parameter tree as tensors on the meta device
    (shape and dtype, no storage, no arithmetic)."""
    return _init(None, cfg, torch.device("meta"))


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embeddings and their positions 0 .. S-1."""
    if cfg.prefix_len and "prefix_embeds" in batch:
        raise NotImplementedError("the multimodal prefix is not ported yet")
    x = embed(params["embed"], batch["tokens"], cfg.cdtype)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return x, positions


def forward(params, batch, cfg: ModelConfig, *, return_caches: bool = False):
    """Full forward: logits over the token sequence.

    Returns ``(logits, aux, caches, None)`` as the reference does for a
    decoder-only model (its last item is the encoder memory).
    """
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models are not ported yet")
    x, positions = _embed_inputs(params, batch, cfg)
    x, aux, caches = stack_forward(params["stack"], x, positions, cfg,
                                   return_caches=return_caches)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.cdtype)
    return logits, aux, caches, None


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def prefill(params, batch, cfg: ModelConfig, max_len: int
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Run the full prompt; return the last position's logits and a decode
    state whose caches hold the prompt's K/V in the decode layout."""
    logits, _, caches, _ = forward(params, batch, cfg, return_caches=True)
    tokens = batch["tokens"]
    b, s = tokens.shape[0], tokens.shape[1]
    state = init_decode_caches(cfg, b, max_len, device=tokens.device)
    _load_prefill_caches(state, caches, s)
    cur = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return logits[:, -1], DecodeState(state, cur)


def _load_prefill_caches(decode_caches, full_caches, seq: int) -> None:
    """Copy prefill K/V into the decode caches (in place) as a tagged ring:
    the last ``cache_len`` positions, at slots ``pos % cache_len``."""
    def load(dst, src):
        cache_len = dst.k.shape[-3]
        take = min(seq, cache_len)
        pos = torch.arange(seq - take, seq, dtype=torch.int32,
                           device=dst.k.device)
        slots = (pos % cache_len).long()
        dst.k[..., slots, :, :] = src.k[..., seq - take:, :, :].to(
            dst.k.dtype)
        dst.v[..., slots, :, :] = src.v[..., seq - take:, :, :].to(
            dst.v.dtype)
        dst.kv_pos[..., slots] = pos.expand_as(src.kv_pos[..., seq - take:])

    for dst, src in zip(decode_caches["prefix"], full_caches["prefix"]):
        load(dst, src)
    for dst, src in zip(decode_caches["slots"], full_caches["slots"]):
        load(dst, src)


def decode_step(params, tokens, state: DecodeState, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, DecodeState]:
    """tokens: (B,) int32 -> (logits (B, V), new state).

    The state's caches are written in place; the new state shares them and
    carries ``cur_pos + 1``.
    """
    x = embed(params["embed"], tokens[:, None], cfg.cdtype)   # (B,1,d)
    x, caches = stack_decode(params["stack"], x, state.caches, state.cur_pos,
                             cfg)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.cdtype)[:, 0]
    return logits, DecodeState(caches, state.cur_pos + 1)
