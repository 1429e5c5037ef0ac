"""Shape-only stand-ins for every model input and state: tensors on the
``meta`` device (shape and dtype, no storage), in place of the
reference's ``jax.ShapeDtypeStruct``s."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

META = torch.device("meta")


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    text_s = s - cfg.prefix_len if cfg.prefix_len else s
    batch = {"tokens": _empty((b, text_s), torch.int32)}
    if cfg.is_encdec:
        # Audio stub: precomputed frame embeddings.
        batch["frames"] = _empty((b, s, cfg.d_model), torch.bfloat16)
    if cfg.prefix_len:
        # Vision stub: precomputed patch embeddings.
        batch["prefix_embeds"] = _empty((b, cfg.prefix_len, cfg.d_model),
                                        torch.bfloat16)
    return batch


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, Any]:
    batch = prefill_input_specs(cfg, shape)
    tokens = batch["tokens"].shape
    batch["labels"] = _empty(tokens, torch.int32)
    batch["loss_mask"] = _empty(tokens, torch.float32)
    return batch


def train_state_specs_shapes(cfg: ModelConfig, tcfg) -> Any:
    """The ``TrainState`` that ``train.init_state`` builds over
    ``models.param_shapes``, on the meta device."""
    from repro_torch.models import param_shapes
    from repro_torch.train import init_state
    return init_state(param_shapes(cfg), tcfg)


def decode_state_shapes(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Tuple[Any, Any]:
    """(DecodeState, tokens) for a decode step of ``shape``, on the meta
    device. An encoder-decoder's state holds no cross-attention caches:
    they need the encoder's memory and the parameters, and the decode
    count covers the self-attention path (cross K/V is static traffic
    computed at prefill), as in the reference."""
    from repro_torch.models.model import DecodeState
    from repro_torch.models.transformer import init_decode_caches

    b = shape.global_batch
    caches = init_decode_caches(cfg, b, shape.seq_len, device=META)
    state = DecodeState(caches, _empty((b,), torch.int32))
    return state, _empty((b,), torch.int32)
