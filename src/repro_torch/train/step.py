"""Train step: microbatched gradient accumulation and AdamW.

The reference's ``repro/train/step.py`` in PyTorch: ``(TrainState, batch)
-> (TrainState, metrics)``. Gradients come from autograd through
:func:`repro_torch.models.loss_fn` (on the card through the flash forward
and backward kernels, under the config's remat policy); the reference's
``lax.scan`` over microbatches is a Python loop, and ``jit_train_step`` is
:func:`make_train_step`, a plain closure. The step updates the state's
parameters and moments in place (:func:`repro_torch.optim.apply`) and
returns a state holding them, as the reference's donated jitted step does.

Batches are dicts of tensors on the parameters' device: ``tokens`` and
``labels`` (B, S) int, ``loss_mask`` (B, S) float.

The cross-pod error-feedback int8 all-reduce (``compress_pod_axis``) waits
for the collective half of ROADMAP Queue A item 15(d) and raises: the
sharding specs (``distributed/sharding.py``) are ported, the all-reduce
across process groups is not.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import optim
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.tree import flatten, map_with_path, tree_map

_NO_COMPRESSION = ("compress_pod_axis (the EF-int8 all-reduce) waits for "
                   "the collective half of ROADMAP Queue A item 15(d): "
                   "distributed/sharding.py's specs are ported, the "
                   "all-reduce across process groups is not")


class TrainState(NamedTuple):
    params: Any
    opt: optim.AdamWState
    residuals: Optional[Any]      # EF-compression residuals (or None)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: optim.AdamWConfig = optim.AdamWConfig()
    microbatches: int = 1          # grad accumulation steps
    compress_pod_axis: Optional[str] = None   # e.g. "pod" on multi-pod mesh
    # Cast >=2-D fp32 params to the compute dtype before they are consumed.
    cast_params_bf16: bool = False


def init_state(params, tcfg: TrainConfig) -> TrainState:
    if tcfg.compress_pod_axis:
        raise NotImplementedError(_NO_COMPRESSION)
    return TrainState(params=params, opt=optim.init(params), residuals=None)


def _split_microbatches(batch, n: int):
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return x.reshape(n, b // n, *x.shape[1:])
    return tree_map(split, batch)


def _cast_params(params, dtype):
    def cast(p):
        if p.dtype == torch.float32 and p.ndim >= 2:
            return p.to(dtype)
        return p
    return tree_map(cast, params)


def _value_and_grad(params, batch, cfg: ModelConfig, cast_bf16: bool):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``: gradients of
    the parameters' own dtype, a tree of their structure (zeros for a leaf
    the loss does not reach)."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        p_in = _cast_params(leaves, cfg.cdtype) if cast_bf16 else leaves
        loss, metrics = loss_fn(p_in, batch, cfg)
        flat = flatten(leaves)
        grads = torch.autograd.grad(loss, list(flat.values()),
                                    allow_unused=True)
    by_path = {k: torch.zeros_like(p) if g is None else g
               for (k, p), g in zip(flat.items(), grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, map_with_path(lambda k, _: by_path[k],
                                                 params)


def grads_and_metrics(params, batch, cfg: ModelConfig, microbatches: int,
                      cast_bf16: bool = False):
    """Value and grad, accumulated over ``microbatches`` slices of the
    batch in fp32; with more than one, the metrics are ``{"loss"}`` only,
    the mean over the slices, as in the reference."""
    if microbatches == 1:
        loss, metrics, grads = _value_and_grad(params, batch, cfg, cast_bf16)
        return grads, dict(metrics, loss=loss)
    mb = _split_microbatches(batch, microbatches)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    loss_sum = None
    for i in range(microbatches):
        loss, _, grads = _value_and_grad(
            params, {k: v[i] for k, v in mb.items()}, cfg, cast_bf16)
        acc = tree_map(torch.add, acc, grads)
        del grads
        loss_sum = loss if loss_sum is None else loss_sum + loss
    grads = tree_map(lambda g: g / microbatches, acc)
    return grads, {"loss": loss_sum / microbatches}


def train_step(state: TrainState, batch, cfg: ModelConfig,
               tcfg: TrainConfig) -> Tuple[TrainState, dict]:
    if tcfg.compress_pod_axis:
        raise NotImplementedError(_NO_COMPRESSION)
    grads, metrics = grads_and_metrics(state.params, batch, cfg,
                                       tcfg.microbatches,
                                       cast_bf16=tcfg.cast_params_bf16)
    new_params, new_opt, opt_metrics = optim.apply(
        tcfg.optimizer, state.params, grads, state.opt)
    del grads
    metrics = {**metrics, **opt_metrics}
    return TrainState(new_params, new_opt, state.residuals), metrics


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """``step(state, batch) -> (state, metrics)`` for ``cfg`` and ``tcfg``
    (the reference's ``jit_train_step``; nothing is compiled)."""
    return functools.partial(train_step, cfg=cfg, tcfg=tcfg)
