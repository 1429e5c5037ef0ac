"""AdamW with decoupled weight decay, global-norm clipping, LR schedules.

The reference's optimizer (``repro/optim/optimizer.py``) in plain PyTorch:
the same state (``step``, fp32 ``m`` and ``v`` congruent with the
parameters), the same schedules and the same update, term by term.
Weight decay applies to every leaf, norms and biases included, as in the
reference (ROADMAP Queue C). The clipping scale and the learning rate are
0-d tensors on the parameters' device: nothing waits for the host.

``apply`` updates the parameters, ``m`` and ``v`` in place and returns
them, where the reference returns new trees (its jitted step donates the
old ones): at qwen2.5-3b's size a second copy of the parameters and both
moments would not fit beside the gradients on one card. On the card each
leaf is updated whole by one launch of the fused update kernel, with the
eager body's bits, and the global norm is a sum-of-squares kernel
(:mod:`repro_torch.kernels.adamw`); CPU tensors take the eager body.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.adamw import adamw_update, sum_squares
from repro_torch.obs.trace import region
from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor        # () int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"      # cosine | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def learning_rate(cfg: AdamWConfig, step) -> torch.Tensor:
    """The schedule at ``step`` (a tensor or an int): linear warmup, then
    cosine or linear decay to ``min_lr_ratio`` of ``lr``, or constant."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = torch.ones_like(frac)
    return cfg.lr * warm * decay


def init(params) -> AdamWState:
    """Zero moments in fp32 beside each parameter, step 0."""
    flat = leaves(params)
    device = flat[0].device if flat else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, on the device."""
    return sum_squares(leaves(tree)).sqrt()


def apply(cfg: AdamWConfig, params, grads, state: AdamWState, *,
          gnorm: Optional[torch.Tensor] = None,
          ) -> Tuple[Any, AdamWState, dict]:
    """One AdamW update, in place. Returns (params, new_state, metrics),
    the parameters and moments being the objects passed in. ``gnorm`` is
    the gradients' global norm when ``grads`` are a rank's blocks of
    them (the sharded step); by default, theirs."""
    with region("optim.adamw"):
        if gnorm is None:
            gnorm = global_norm(grads)
        if cfg.grad_clip:
            scale = torch.clamp(
                cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        else:
            scale = torch.ones((), device=gnorm.device)
        step = state.step + 1
        lr = learning_rate(cfg, step)
        b1c = 1 - torch.pow(cfg.b1, step.float())
        b2c = 1 - torch.pow(cfg.b2, step.float())

        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            adamw_update(p, g, m, v, scale, lr, b1c, b2c, b1=cfg.b1,
                         b2=cfg.b2, eps=cfg.eps,
                         weight_decay=cfg.weight_decay)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return params, AdamWState(step, state.m, state.v), metrics
