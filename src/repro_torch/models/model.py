"""Top-level model: embeddings -> stack(s) -> head; prefill and decode.

``init_params`` draws the weights on the card (or ``device``) from a seeded
``torch.Generator``; :func:`repro_torch.models.convert.params_from_jax`
turns the reference's own weights into the same structure.
``forward`` is the prefill pass with the reference's return value.
``prefill`` runs it and lays its caches (K/V, MLA's latents, Mamba's conv
inputs and state) into the decode caches in place; ``decode_step``
advances every row by one token, writing the caches in place.

Multimodal archs take *precomputed* frontend embeddings, as the reference
does: ``batch["prefix_embeds"]`` (B, P, d), concatenated before the token
embeddings and cut from the logits (phi-3-vision's patches), and
``batch["frames"]`` (B, S_enc, d), the encoder's input (seamless-m4t's
audio frames). The frontends are stubs; the backbone is exact.
``loss_fn`` is the training loss: the token-mean cross entropy with the
z-loss over ``forward``'s logits, plus the MoE auxiliary loss. Under the
sharded step's tensor parallelism ``forward``'s logits are this rank's
block of the vocabulary (``layers.unembed``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from .attention import KVCacheView
from .layers import (
    embed,
    init_embed,
    init_rms_norm,
    rms_norm,
    softmax_cross_entropy,
    unembed,
)
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
    p = {
        "embed": init_embed(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype,
                            device, cfg.tie_embeddings),
        "stack": init_stack(gen, cfg, device, cross_attn=cfg.is_encdec),
        "final_norm": init_rms_norm(cfg.d_model, cfg.pdtype, device),
    }
    if cfg.is_encdec:
        p["encoder"] = init_stack(gen, cfg, device, encoder=True)
        p["enc_norm"] = init_rms_norm(cfg.d_model, cfg.pdtype, device)
    return p


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


def _encode(params, batch, cfg: ModelConfig):
    """The encoder over the stub frame embeddings: its normalised memory."""
    frames = batch["frames"].to(cfg.cdtype)          # (B, S_enc, d)
    b, s, _ = frames.shape
    pos = torch.arange(s, dtype=torch.int32,
                       device=frames.device).expand(b, s)
    h, _, _ = stack_forward(params["encoder"], frames, pos, cfg, encoder=True)
    return rms_norm(h, params["enc_norm"]["scale"], cfg.norm_eps)


def _prefix(batch, cfg: ModelConfig) -> int:
    """Positions the multimodal prefix takes ahead of the tokens."""
    if cfg.prefix_len and "prefix_embeds" in batch:
        return batch["prefix_embeds"].shape[1]
    return 0


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embeddings (after the multimodal prefix, if any) and their
    positions 0 .. S-1."""
    x = embed(params["embed"], batch["tokens"], cfg.cdtype, cfg.padded_vocab)
    if _prefix(batch, cfg):
        x = torch.cat([batch["prefix_embeds"].to(cfg.cdtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return x, positions


def forward(params, batch, cfg: ModelConfig, *, return_caches: bool = False):
    """Full forward: logits over the token sequence (the prefix's positions
    cut away). Returns ``(logits, aux, caches, memory)`` as the reference
    does, ``memory`` the encoder's output (None without an encoder)."""
    memory = _encode(params, batch, cfg) if cfg.is_encdec else None
    x, positions = _embed_inputs(params, batch, cfg)
    x, aux, caches = stack_forward(params["stack"], x, positions, cfg,
                                   memory=memory, return_caches=return_caches)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    x = x[:, _prefix(batch, cfg):]
    logits = unembed(params["embed"], x, cfg.cdtype, cfg.padded_vocab)
    return logits, aux, caches, memory


def loss_fn(params, batch, cfg: ModelConfig, *, denom=None):
    """``(ce + z_weight * z + aux, {"ce", "z_loss", "aux", "loss"})`` of
    ``batch`` (``tokens``, ``labels`` and an optional ``loss_mask``); the
    token means over ``denom`` when it is given (a rank's rows of a batch
    whose mask sums to ``denom`` over the ranks)."""
    logits, aux, _, _ = forward(params, batch, cfg)
    loss, metrics = softmax_cross_entropy(logits, batch["labels"],
                                          batch.get("loss_mask"),
                                          denom=denom, vocab=cfg.padded_vocab)
    total = loss + aux
    return total, dict(metrics, aux=aux, loss=total)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def prefill(params, batch, cfg: ModelConfig, max_len: int
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Run the full prompt; return the last position's logits and a decode
    state whose caches hold the prompt's K/V (and an encoder-decoder's
    cross-attention K/V of the memory) in the decode layout."""
    logits, _, caches, memory = forward(params, batch, cfg,
                                        return_caches=True)
    tokens = batch["tokens"]
    b, s = tokens.shape[0], tokens.shape[1] + _prefix(batch, cfg)
    state = init_decode_caches(cfg, b, max_len, device=tokens.device,
                               memory=memory, params=params["stack"])
    _load_prefill_caches(state, caches, s)
    cur = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return logits[:, -1], DecodeState(state, cur)


def _load_prefill_caches(decode_caches, full_caches, seq: int) -> None:
    """Copy the prefill's caches into the decode caches (in place): K/V as
    a tagged ring, the last ``cache_len`` positions at slots
    ``pos % cache_len`` (MLA's zero-width V left as it is); a
    ``MambaCache`` as it is, its final conv inputs and state."""
    def load(dst, src):
        if not isinstance(dst, KVCacheView):
            for d, s_ in zip(dst, src):
                d.copy_(s_)
            return
        cache_len = dst.k.shape[-3]
        take = min(seq, cache_len)
        pos = torch.arange(seq - take, seq, dtype=torch.int32,
                           device=dst.k.device)
        slots = (pos % cache_len).long()
        dst.k[..., slots, :, :] = src.k[..., seq - take:, :, :].to(
            dst.k.dtype)
        if dst.v.shape[-1]:
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
