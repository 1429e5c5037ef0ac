"""Top-level model: embeddings -> stack -> head; the prefill forward.

``init_params`` draws the weights on the card (or ``device``) from a seeded
``torch.Generator``; :func:`repro_torch.models.convert.params_from_jax`
turns the reference's own weights into the same structure.
``forward`` is the decoder-only prefill pass with the reference's return
value. The multimodal prefix, the encoder, ``prefill``/``decode_step`` and
``loss_fn`` are the reference's and wait for the serve and train slices.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from .layers import embed, init_embed, init_rms_norm, rms_norm, unembed
from .transformer import init_stack, stack_forward


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
