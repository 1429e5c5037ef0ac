"""Logical-axis sharding state: the thread's mesh and its rule table, and
the collectives along a mesh's axes.

Models annotate tensors with *logical* axis names; a per-launch rule table
maps them to mesh axes (MaxText-style). In this package a mesh is a
:class:`Mesh` — an array of ``torch.device`` objects with a named
``shape`` — and :func:`shard` is the identity: the sharded DMA runtime
places each shard's pools on its mesh device itself
(``ShardedDMARuntime._place``), and no tensor is partitioned by a
constraint.

A mesh may be backed by process groups (:func:`repro_torch.launch.mesh.
make_process_mesh`): SPMD over ``torch.distributed``, one process per mesh
position, which holds the process group along every set of axes and its
own coordinates. The training path runs its collectives there: the
differentiable :func:`reduce_from`, :func:`copy_to` and :func:`pmean` (the
counterparts of ``psum`` and ``pmean`` inside the reference's
``shard_map``), and :func:`all_reduce_` / :func:`all_gather` /
:func:`reduce_scatter` for gradients, parameters and checkpoints. A mesh
without that backing (the sharded runtime's logical shards, the
production meshes of ``meta`` devices, :func:`make_debug_mesh` over one
device) has none of them. A model leaf the sharded step hands over as
this rank's block on ``model`` (tensor parallelism) says so by its
length: :func:`model_block`.

Collectives run on the tensors' own device over the world's backend;
nothing switches either. gloo runs ``all_reduce`` (sum and max),
``broadcast``, ``all_gather``, ``gather`` and ``reduce_scatter_tensor``
on CUDA tensors itself (int8, fp32 and bf16 checked on the H100 with
torch 2.11, ``tools/gloo_collectives_probe.py``): it copies through host
memory inside the collective, so its times measure loopback, not NVLink.

Lifecycle contract: the mesh and the rule table live and die together.
``set_mesh(None)`` (== ``clear_mesh()``) drops the rules too — rules are
*interpretations of a mesh*, and letting them outlive it silently
re-applies a stale mapping to the next mesh. State is thread-local, so
concurrent launchers (e.g. a serving thread next to a background defrag
thread) never observe each other's mesh; ``use_mesh`` is the scoped form.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from typing import (Dict, Iterator, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

Rules = Dict[str, Union[str, Tuple[str, ...], None]]
Axes = Union[str, Sequence[str], None]

_state = threading.local()


class Mesh:
    """Devices laid out on named axes: ``Mesh(devices, ("dma",))``.

    ``devices`` is an array-like of ``torch.device`` (or device strings)
    whose shape gives the axis sizes; ``shape`` maps each axis name to its
    size and ``devices`` keeps the array, so ``devices.flat`` lists the
    devices in mesh order.
    """

    def __init__(self, devices, axis_names: Sequence[str], *,
                 rank: Optional[int] = None, backend: Optional[str] = None):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[idx] = torch.device(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D device array for "
                             f"{len(axis_names)} axis names")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape: Mapping[str, int] = dict(zip(self.axis_names, arr.shape))
        self.rank = rank
        self.backend = backend
        self._groups: Dict[Tuple[str, ...], object] = {}
        #: Bytes the sharded train step moved through this mesh's
        #: collectives, summed over its steps, by kind (``train/step.py``).
        self.traffic: Dict[str, int] = {}
        if rank is not None:
            self._new_groups()

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)!r})"

    # -- process-group backing ----------------------------------------------
    def _new_groups(self) -> None:
        """One process group for every set of axes, over the ranks that
        share the other axes' coordinates, in mesh order (the first axis
        major). Every rank creates every group, in one order, as
        ``torch.distributed.new_group`` requires."""
        import torch.distributed as dist
        ranks = np.arange(self.devices.size).reshape(self.devices.shape)
        if not 0 <= self.rank < ranks.size:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{ranks.size}")
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            map(int, np.unravel_index(self.rank, ranks.shape))))
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                keep = [self.axis_names.index(a) for a in axes]
                rest = [i for i in range(ranks.ndim) if i not in keep]
                cols = ranks.transpose(rest + keep).reshape(
                    -1, int(np.prod([ranks.shape[i] for i in keep])))
                for col in cols:
                    g = dist.new_group([int(r) for r in col])
                    if self.rank in col:
                        self._groups[axes] = g

    @property
    def is_process_mesh(self) -> bool:
        """Whether process groups back this mesh (one process a position)."""
        return self.rank is not None

    def axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` (a name, names, or None) as a tuple in mesh order, the
        names this mesh lacks left out."""
        if axes is None:
            return ()
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in names)

    def size(self, axes: Axes) -> int:
        """The number of positions along ``axes``."""
        return int(np.prod([self.shape[a] for a in self.axes(axes)]))

    def index(self, axes: Axes) -> int:
        """This rank's position along ``axes``, in mesh order (the first
        axis major): its index in :meth:`group`'s ranks."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: Axes):
        """The process group along ``axes`` that holds this rank."""
        if not self.is_process_mesh:
            raise RuntimeError(f"{self!r} is not backed by process groups")
        key = self.axes(axes)
        if not key:
            raise ValueError(f"no axis of {self!r} in {axes!r}")
        return self._groups[key]

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices.flat[self.rank]

    def count(self, kind: str, nbytes: int) -> None:
        """Add ``nbytes`` to :attr:`traffic` under ``kind``."""
        self.traffic[kind] = self.traffic.get(kind, 0) + int(nbytes)


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


# ---------------------------------------------------------------------------
# Collectives along a process mesh's axes
# ---------------------------------------------------------------------------

def process_mesh() -> Optional[Mesh]:
    """The thread's mesh if process groups back it, else None."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.is_process_mesh else None


def _mesh_for(mesh: Optional[Mesh]) -> Mesh:
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or not mesh.is_process_mesh:
        raise RuntimeError("a collective needs a mesh backed by process "
                           "groups (launch.mesh.make_process_mesh)")
    return mesh


def all_reduce_(t: torch.Tensor, axes: Axes, mesh: Optional[Mesh] = None,
                op: str = "sum") -> torch.Tensor:
    """Sum (or with ``op="max"``, the largest of) ``t`` over ``axes`` in
    place (every rank gets the same bytes); the identity along a single
    position."""
    mesh = _mesh_for(mesh)
    if mesh.size(axes) > 1:
        import torch.distributed as dist
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=mesh.group(axes))
    return t


def all_gather(t: torch.Tensor, axes: Axes, mesh: Optional[Mesh] = None
               ) -> List[torch.Tensor]:
    """Every rank's ``t`` along ``axes`` (equal shapes), in mesh order."""
    mesh = _mesh_for(mesh)
    n = mesh.size(axes)
    if n == 1:
        return [t]
    import torch.distributed as dist
    src = t.contiguous()
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=mesh.group(axes))
    return outs


def reduce_scatter(t: torch.Tensor, axes: Axes, dim: int,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``t`` summed over ``axes``, of which this rank keeps its block of
    dim ``dim``: the dim splits into ``mesh.size(axes)`` equal blocks in
    mesh order (the first axis major), the order of
    ``sharding.take_block``. The identity along a single position."""
    mesh = _mesh_for(mesh)
    n = mesh.size(axes)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} positions of {mesh.axes(axes)}")
    import torch.distributed as dist
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=mesh.group(axes))
    return out.movedim(0, dim).contiguous()


def gather_to_first(t: torch.Tensor, mesh: Optional[Mesh] = None
                    ) -> Optional[List[torch.Tensor]]:
    """Every rank's ``t`` (equal shapes) on rank 0 of the world, by rank,
    as host tensors; None on the other ranks. For checkpoints: each block
    crosses once, to the one writer (from the host under gloo, from the
    device under NCCL, which gathers device tensors only)."""
    import torch.distributed as dist
    mesh = _mesh_for(mesh)
    src = t.detach().contiguous()
    if mesh.backend != "nccl":
        src = src.cpu()
    n = mesh.devices.size
    if n == 1:
        return [src.to("cpu", copy=True)]
    outs = [torch.empty_like(src) for _ in range(n)] if mesh.rank == 0 \
        else None
    dist.gather(src, outs, dst=0)
    return None if outs is None else [o.cpu() for o in outs]


class _ReduceFrom(torch.autograd.Function):
    """Sum over ``axes`` forward; identity backward (the cotangent of the
    sum is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        return all_reduce_(x.clone(), axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward; sum of the gradient over ``axes`` backward (each
    rank's consumers see part of the uses of ``x``)."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axes, ctx.mesh), None, None


class _PMean(torch.autograd.Function):
    """Mean over ``axes`` forward; the gradient over the size backward,
    with no communication: the step sums gradients over the batch axes,
    so each rank carries its own share of a replicated mean."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.n = mesh.size(axes)
        return all_reduce_(x.clone(), axes, mesh) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _collective(fn, x: torch.Tensor, axes: Axes, mesh: Optional[Mesh]):
    mesh = process_mesh() if mesh is None else mesh
    if mesh is None or mesh.size(axes) == 1:
        return x
    return fn.apply(x, mesh.axes(axes), mesh)


def reduce_from(x: torch.Tensor, axes: Axes,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``psum`` of a partial result over ``axes`` whose consumer is
    replicated: all-reduce forward, identity backward. The identity off a
    process mesh or along one position."""
    return _collective(_ReduceFrom, x, axes, mesh)


def copy_to(x: torch.Tensor, axes: Axes,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """A replicated input entering rank-local work along ``axes``:
    identity forward, all-reduce of the gradient backward."""
    return _collective(_CopyTo, x, axes, mesh)


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 mesh: Mesh) -> torch.Tensor:
    """``x @ w`` where ``x``'s last dim and ``w``'s rows are this rank's
    block of the contraction on ``model`` (Megatron's row split): each
    rank's part in fp32, summed over ``model`` with :func:`reduce_from`,
    then rounded to ``x``'s dtype once, as one process's product rounds
    its fp32 sum once (bf16 parts summed in bf16 would round three
    times)."""
    y = x.float() @ w.float()
    return reduce_from(y, "model", mesh).to(x.dtype)


def model_block(local: int, full: int) -> Optional[Tuple[Mesh, int]]:
    """Whether a leaf dim of ``full`` entries that a model finds ``local``
    long is this rank's block of it on ``model`` (tensor parallelism: the
    sharded step gathers such a leaf over the batch axes only): ``(mesh,
    block index)``, or None for a whole dim. The split is read from the
    leaf, never decided from the mesh."""
    if local == full:
        return None
    mesh = process_mesh()
    if mesh is None or "model" not in mesh.shape \
            or local * mesh.shape["model"] != full:
        raise ValueError(f"a leaf dim of {local} where the model has "
                         f"{full} is no block of {mesh!r} along model")
    return mesh, mesh.coords["model"]


def pmean(x: torch.Tensor, axes: Axes,
          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean over ``axes`` (the reference's ``lax.pmean``); the gradient
    divided by their size (see :class:`_PMean`)."""
    return _collective(_PMean, x, axes, mesh)
