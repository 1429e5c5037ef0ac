"""The reference's parameters, as numpy arrays, in the port's structure.

The reference keeps each pattern slot's block parameters stacked over
periods (a leading axis of length ``num_periods``) and lists and tuples as
its tree's nodes. :func:`params_from_jax` gives the port's tree: the same
dict keys, one dict per (slot, period) in the decoder stack and, for an
encoder-decoder, in the encoder stack, tensors on ``device`` in the
arrays' own dtypes. The tests feed both packages the same weights through
it, from ``tree_map(np.asarray, init_params(key, cfg))`` of the reference.
:func:`decode_state_from_jax` does the same for the reference's
``DecodeState`` (K/V and MLA latent caches, Mamba caches and the
cross-attention caches), so a decode step of each package can start from
one state, and :func:`train_state_from_jax` for the reference's
``TrainState`` (parameters and AdamW's ``m`` and ``v``, all stacked over
periods in the reference, and ``step``), so a train step can.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.tree import leaves
from .attention import KVCacheView
from .mamba import MambaCache
from .model import DecodeState
from .transformer import CrossCache, n_periods

#: The reference's cache tuples by their fields.
_CACHES = {c._fields: c for c in (KVCacheView, MambaCache, CrossCache)}


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def _period(tree, i: int):
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(stack, periods: int, dev) -> Dict:
    slots = []
    for slot in stack["slots"]:
        lead = {np.shape(a)[0] for a in leaves(slot)}
        if lead != {periods}:
            raise ValueError(f"slot parameters lead with {sorted(lead)}, "
                             f"expected {periods} periods")
        slots.append([_tensors(_period(slot, i), dev)
                      for i in range(periods)])
    return {"prefix": [_tensors(p, dev) for p in stack["prefix"]],
            "slots": tuple(slots)}


def params_from_jax(tree: Dict, cfg: ModelConfig, device=None) -> Dict:
    """Port parameters from the reference's parameter tree of numpy arrays.

    ``tree["stack"]["slots"][j]`` (and ``tree["encoder"]["slots"][j]``)
    holds slot j's blocks stacked over periods; the port gets
    ``[block of period 0, block of period 1, ...]``.
    """
    dev = resolve_device(device)
    stacks = {"stack": n_periods(cfg)}
    if cfg.is_encdec:
        stacks["encoder"] = n_periods(cfg, encoder=True)
    out = {k: _tensors(v, dev) for k, v in tree.items() if k not in stacks}
    for k, periods in stacks.items():
        out[k] = _stack(tree[k], periods, dev)
    return out


def decode_state_from_jax(state, cfg: ModelConfig, device=None
                          ) -> DecodeState:
    """Port decode state from the reference's ``DecodeState`` of numpy
    arrays (``tree_map(np.asarray, state)``): the same caches (each of the
    reference's cache tuples as the port's of the same fields), stacked
    slots included, as fresh tensors on ``device``."""
    dev = resolve_device(device)
    caches, cur_pos = state
    extra = set(caches) - {"prefix", "slots", "cross_prefix", "cross_slots"}
    if extra:
        raise ValueError(f"unknown decode caches {sorted(extra)}")
    periods = n_periods(cfg)

    def view(c):
        return _CACHES[tuple(c._fields)](*(_tensors(x, dev) for x in c))

    out = {}
    for key in ("prefix", "slots", "cross_prefix", "cross_slots"):
        if key in caches:
            out[key] = type(caches[key])(view(c) for c in caches[key])
    for key in ("slots", "cross_slots"):
        if any(c[0].shape[0] != periods for c in out.get(key, ())):
            raise ValueError(f"{key} caches must lead with {periods} "
                             "periods")
    return DecodeState(out, _tensors(cur_pos, dev).to(torch.int32))


def train_state_from_jax(state, cfg: ModelConfig, device=None):
    """Port train state from the reference's ``TrainState`` of numpy
    arrays (``tree_map(np.asarray, state)``): the parameters, both
    moments and the EF-int8 residuals (when the reference has them)
    through :func:`params_from_jax`, the step as an int32 scalar."""
    from repro_torch.optim import AdamWState
    from repro_torch.train import TrainState

    dev = resolve_device(device)
    params, opt, residuals = state
    step, m, v = opt
    return TrainState(
        params=params_from_jax(params, cfg, dev),
        opt=AdamWState(step=torch.tensor(int(np.asarray(step)),
                                         dtype=torch.int32, device=dev),
                       m=params_from_jax(m, cfg, dev),
                       v=params_from_jax(v, cfg, dev)),
        residuals=None if residuals is None
        else params_from_jax(residuals, cfg, dev))
