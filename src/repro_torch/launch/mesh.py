"""Production, debug and process meshes. Functions only: importing this
module touches no device.

A mesh here is a :class:`repro_torch.distributed.shardlib.Mesh`, a layout
of devices on named axes. The production meshes hold ``meta`` devices:
they name the chips a deployment would span, for the dry run's per-chip
counts (:mod:`repro_torch.launch.dryrun`), and nothing runs on them.
:func:`make_process_mesh` lays the ranks of an initialised
``torch.distributed`` world on the axes, one process a position, and backs
the mesh with a process group along every set of axes.
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


def make_process_mesh(data: int, model: int, pod: int = 0, *, backend: str,
                      device) -> Mesh:
    """The mesh of ``make_debug_mesh``'s axes over the processes of the
    ``torch.distributed`` world, world rank ``r`` at mesh position ``r`` in
    mesh order (the first axis major); ``device`` is this process's device
    (the same string on every rank names each rank's own).

    Runs after ``init_process_group``, on every rank. ``backend`` must be
    the world's: nothing falls back to another. An all-reduce over the
    world checks the backend before any group is made; NCCL refuses two
    ranks on one GPU there, and the error stands.
    """
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_process_mesh runs after "
                           "torch.distributed.init_process_group")
    shape = (pod, data, model) if pod else (data, model)
    axes = ("pod", "data", "model") if pod else ("data", "model")
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs {n} "
                         f"ranks, the world has {world}")
    got = dist.get_backend()
    if got != backend:
        raise ValueError(f"the world runs {got}, not {backend}")
    dev = resolve_device(device)
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != n:
        raise RuntimeError(f"{backend} all-reduce over {n} ranks gave "
                           f"{probe.item()}")
    # Every position names its own rank's device: the world's devices are
    # not known here, so each position holds this rank's device.
    arr = np.empty(n, dtype=object)
    arr[:] = [dev] * n
    return Mesh(arr.reshape(shape), axes, rank=dist.get_rank(),
                backend=backend)
