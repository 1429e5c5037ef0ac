"""Production and debug meshes. Functions only: importing this module
touches no device.

A mesh here is a :class:`repro_torch.distributed.shardlib.Mesh`, a layout
of devices on named axes. The production meshes hold ``meta`` devices:
they name the chips a deployment would span, for the dry run's per-chip
counts (:mod:`repro_torch.launch.dryrun`), and nothing runs on them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.shardlib import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2x16x16 = 512 chips across two pods.

    Axes: (pod,) data, model — ``pod`` the slow inter-pod axis, ``data``
    the FSDP/batch axis, ``model`` the TP/EP axis.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.full(shape, torch.device("meta"), dtype=object), axes)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0,
                    devices=None) -> Mesh:
    """A small mesh over the devices it is given: a sequence of
    ``data * model`` (times ``pod``) devices in mesh order, or one device
    laid at every position (one card, or the CPU). ``devices`` defaults to
    ``cuda``."""
    shape = (pod, data, model) if pod else (data, model)
    axes = ("pod", "data", "model") if pod else ("data", "model")
    n = int(np.prod(shape))
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = [resolve_device(devices)] * n
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a {shape} mesh needs {n} devices, "
                         f"got {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axes)
