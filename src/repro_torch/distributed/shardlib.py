"""Logical-axis sharding state: the thread's mesh and its rule table.

Models annotate tensors with *logical* axis names; a per-launch rule table
maps them to mesh axes (MaxText-style). In this package a mesh is a
:class:`Mesh` — a tuple of ``torch.device`` objects with a named ``shape``
— and :func:`shard` is the identity: the sharded DMA runtime places each
shard's pools on its mesh device itself (``ShardedDMARuntime._place``), and
no model code is partitioned across devices.

Lifecycle contract: the mesh and the rule table live and die together.
``set_mesh(None)`` (== ``clear_mesh()``) drops the rules too — rules are
*interpretations of a mesh*, and letting them outlive it silently
re-applies a stale mapping to the next mesh. State is thread-local, so
concurrent launchers (e.g. a serving thread next to a background defrag
thread) never observe each other's mesh; ``use_mesh`` is the scoped form.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Rules = Dict[str, Union[str, Tuple[str, ...], None]]

_state = threading.local()


class Mesh:
    """Devices laid out on named axes: ``Mesh(devices, ("dma",))``.

    ``devices`` is an array-like of ``torch.device`` (or device strings)
    whose shape gives the axis sizes; ``shape`` maps each axis name to its
    size and ``devices`` keeps the array, so ``devices.flat`` lists the
    devices in mesh order.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[idx] = torch.device(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D device array for "
                             f"{len(axis_names)} axis names")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape: Mapping[str, int] = dict(zip(self.axis_names, arr.shape))

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)!r})"


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Install (or with None, tear down) the thread's mesh.

    Tearing down the mesh also clears the rules: the mesh/rules lifecycle
    is symmetric, so ``set_mesh(None)`` and ``clear_mesh()`` leave the
    thread in the identical pristine state.
    """
    _state.mesh = mesh
    if mesh is None:
        _state.rules = {}


def clear_mesh() -> None:
    set_mesh(None)


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


def set_rules(rules: Rules) -> None:
    _state.rules = dict(rules)


def current_rules() -> Rules:
    return getattr(_state, "rules", {})


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh],
             rules: Optional[Rules] = None) -> Iterator[Optional[Mesh]]:
    """Scoped mesh+rules install; restores the previous pair on exit.

    The exception-safe form of the set/clear pair: state never leaks out
    of the ``with`` block — even when the *install itself* throws (a bad
    rule table must not leave the new mesh half-installed), and even when
    the body resizes or tears down the mesh before raising (elastic
    resize: the body may legitimately ``set_mesh`` a grown/shrunk mesh;
    on error the pre-``with`` pair still comes back).
    """
    prev_mesh = current_mesh()
    prev_rules = dict(current_rules())
    try:
        set_mesh(mesh)
        if rules is not None:
            set_rules(rules)
        yield mesh
    finally:
        set_mesh(prev_mesh)
        set_rules(prev_rules)


def axis_size(mesh_axis: str) -> int:
    mesh = current_mesh()
    if mesh is None or mesh_axis not in mesh.shape:
        return 1
    return mesh.shape[mesh_axis]


def logical_spec(*logical_axes: Optional[str]) -> Tuple:
    """Resolve logical axis names to mesh axes under the current rules
    (a tuple in the place of JAX's ``PartitionSpec``)."""
    rules = current_rules()
    return tuple(None if ax is None else rules.get(ax)
                 for ax in logical_axes)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The identity: tensors are not partitioned across a mesh here. The
    rank check still runs under a mesh, as the reference's does."""
    if current_mesh() is not None and len(logical_axes) != x.ndim:
        raise ValueError(
            f"shard(): got {len(logical_axes)} axes for rank-{x.ndim} tensor")
    return x
