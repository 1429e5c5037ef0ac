"""The reference's parameters, as numpy arrays, in the port's structure.

The reference keeps each pattern slot's block parameters stacked over
periods (a leading axis of length ``num_periods``) and lists and tuples as
its tree's nodes. :func:`params_from_jax` gives the port's tree: the same
dict keys, one dict per (slot, period), tensors on ``device`` in the
arrays' own dtypes. The tests feed both packages the same weights through
it, from ``tree_map(np.asarray, init_params(key, cfg))`` of the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from .transformer import n_periods


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


def params_from_jax(tree: Dict, cfg: ModelConfig, device=None) -> Dict:
    """Port parameters from the reference's parameter tree of numpy arrays.

    ``tree["stack"]["slots"][j]`` holds slot j's blocks stacked over
    periods; the port gets ``[block of period 0, block of period 1, ...]``.
    """
    dev = resolve_device(device)
    periods = n_periods(cfg)
    out = {k: _tensors(v, dev) for k, v in tree.items() if k != "stack"}
    stack = tree["stack"]
    slots = []
    for slot in stack["slots"]:
        lead = {np.shape(a)[0] for a in _leaves(slot)}
        if lead != {periods}:
            raise ValueError(f"slot parameters lead with {sorted(lead)}, "
                             f"expected {periods} periods")
        slots.append([_tensors(_period(slot, i), dev)
                      for i in range(periods)])
    out["stack"] = {"prefix": [_tensors(p, dev) for p in stack["prefix"]],
                    "slots": tuple(slots)}
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
