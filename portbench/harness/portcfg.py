"""The program's side of a configuration: its model configuration for a
configuration file (the registered architecture ``port.arch`` with the
file's ``port.replace`` fields, a nested group such as ``moe`` replaced
field by field), and the layout of its parameter tree."""
from __future__ import annotations

import dataclasses
from typing import Dict


def build(config: dict):
    from repro_torch.configs import get_config
    base = get_config(config["port"]["arch"])
    rep = dict(config["port"]["replace"])
    for k, v in list(rep.items()):
        if isinstance(v, dict):
            rep[k] = dataclasses.replace(getattr(base, k), **v)
    return dataclasses.replace(base, **rep)


def leaf_shapes(cfg) -> Dict[str, tuple]:
    """{path: (shape, dtype)} of every leaf of the program's parameter
    tree for ``cfg`` (from its meta-device shapes; nothing is computed)."""
    from repro_torch.models import param_shapes
    from repro_torch.tree import flatten
    return {k: (tuple(v.shape), v.dtype)
            for k, v in flatten(param_shapes(cfg)).items()}


def tree(cfg, leaves: dict):
    """The program's parameter tree for ``cfg`` holding ``leaves`` (a dict
    by path)."""
    from repro_torch.models import param_shapes
    from repro_torch.tree import map_with_path
    return map_with_path(lambda k, _: leaves[k], param_shapes(cfg))
