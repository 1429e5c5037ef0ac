"""Sharding policies: FSDP x TP x EP (x SP for long-context decode).

The reference's partition specs, as pure functions of shapes and named
mesh axes. Parameters and optimizer state shard (fsdp_axes, "model")
MaxText-style (ZeRO-3 equivalent). Activations shard batch over (pod,
data); logical axes inside the model map via shardlib rules. KV/SSM caches
shard batch over data — or the *sequence/page* axis when global_batch <
data-axis size (long-context SP with distributed partial softmax).

The specs serve the dry run's per-chip counts (:func:`shard_shape`,
:func:`per_device`), which take the place of the reference's
``to_named``/``NamedSharding``, and the sharded train step on a process
mesh (``train/step.py``): :func:`take_block` cuts a rank's block of a
leaf, :func:`gather_leaf` all-gathers the blocks back, and
:func:`assemble` lays every rank's block into the leaf (a checkpoint's
save). A spec is a :class:`P`, one entry per leading dim (``None``, a
mesh axis, or a tuple of axes); its ``own`` names axes along which each
position keeps a block of its own that spans every position's share (a
pod's error-feedback residual, :func:`train_state_block_specs`).

Layout of stacked parameters: the reference stacks a pattern slot's blocks
over periods (a leading periods axis under ``slots``, which its specs
lead with ``None``); the port keeps one dict per (slot, period),
``params["slots"][j][i]``, so its spec for a block leaf is the reference's
stacked spec without that leading ``None``, checked for divisibility on the
unstacked shape. Decode caches keep the reference's stacked layout in both
packages, so their specs are the reference's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import flatten, map_with_path


class P:
    """A partition spec: a tuple of entries (``None``, an axis name, or a
    tuple of axis names), one per leading dim. Not a tuple, so the port's
    tree walkers take it as a leaf."""

    __slots__ = ("entries", "own")

    def __init__(self, *entries, own: Tuple[str, ...] = ()):
        self.entries = tuple(entries)
        self.own = tuple(own)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return (isinstance(other, P) and self.entries == other.entries
                and self.own == other.own)

    def __hash__(self) -> int:
        return hash((self.entries, self.own))

    def __repr__(self) -> str:
        v = f", own={self.own!r}" if self.own else ""
        return f"P{self.entries!r}{v}"


def _axes(mesh) -> Dict[str, int]:
    return dict(mesh.shape)


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def activation_rules(mesh) -> dict:
    """Logical-axis -> mesh-axis map consumed by shardlib."""
    fs = fsdp_axes(mesh)
    return {
        "batch": fs if len(fs) > 1 else (fs[0] if fs else None),
        "seq": None,
        "heads": "model" if "model" in mesh.shape else None,
        "kv_heads": None,          # GQA kv heads replicated across TP
        "d_ff": "model" if "model" in mesh.shape else None,
        "experts": "model" if "model" in mesh.shape else None,
        "expert_cap": fs if len(fs) > 1 else (fs[0] if fs else None),
        "vocab": "model" if "model" in mesh.shape else None,
    }


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh) -> P:
    """The spec of the parameter leaf at ``path`` (its names, root first)."""
    fs = fsdp_axes(mesh)
    axes = _axes(mesh)
    FSDP = fs if len(fs) > 1 else (fs[0] if fs else None)
    M = "model" if "model" in mesh.shape else None
    leaf = path[-1]
    ndim = len(shape)

    def spec(*entries):
        # Guard divisibility: drop axes that don't divide the dim.
        fixed = []
        for i, e in enumerate(entries):
            if e is None:
                fixed.append(None)
                continue
            size = math.prod(axes.get(a, 1)
                             for a in (e if isinstance(e, tuple) else (e,)))
            dim = shape[i] if i < ndim else 1
            fixed.append(e if dim % size == 0 else None)
        return P(*fixed)

    if leaf == "embedding":
        return spec(M, FSDP)
    if leaf == "unembed":
        return spec(FSDP, M)
    if leaf == "wq":
        return spec(FSDP, M, None)
    if leaf in ("wk", "wv"):
        return spec(FSDP, None, None)
    if leaf == "wo":
        return spec(M, None, FSDP)
    if leaf == "bq":
        return spec(M, None)
    if leaf in ("bk", "bv"):
        return spec(None, None)
    if leaf in ("q_down", "kv_down"):
        return spec(FSDP, None)
    if leaf in ("q_up", "kv_up"):
        return spec(None, M, None)
    if leaf == "router":
        return spec(None, None)
    if leaf in ("w_gate", "w_up"):
        if ndim == 3:               # MoE experts (E, d, f)
            return spec(M, FSDP, None)
        return spec(FSDP, M)
    if leaf == "w_down":
        if ndim == 3:
            return spec(M, None, FSDP)
        return spec(M, FSDP)
    if leaf == "in_proj":
        return spec(FSDP, None)
    if leaf == "out_proj":
        return spec(None, FSDP)
    # conv_w, conv_b, dt_bias, A_log, D, scale, and anything else: replicate.
    return spec(*(None,) * ndim)


def param_specs(cfg: ModelConfig, mesh, shapes_tree: Any) -> Any:
    """A :class:`P` tree congruent with ``shapes_tree`` (``param_shapes``)."""
    return map_with_path(
        lambda path, leaf: _param_spec(tuple(path.split("/")),
                                       tuple(leaf.shape), mesh),
        shapes_tree)


def strip(spec: P, drop: Tuple[str, ...]) -> P:
    """``spec`` without the axes in ``drop``."""
    entries = []
    for e in spec:
        if e is None:
            entries.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a not in drop)
            entries.append(kept if len(kept) > 1 else
                           (kept[0] if kept else None))
        else:
            entries.append(None if e in drop else e)
    return P(*entries, own=tuple(a for a in spec.own if a not in drop))


def serving_param_specs(cfg: ModelConfig, mesh, shapes_tree: Any) -> Any:
    """Serving layout: TP over ``model`` only; replicated over (pod, data).

    Training's FSDP layout would re-all-gather every parameter on every
    decode step; serving replicas keep full TP shards resident instead.
    """
    fs = fsdp_axes(mesh)
    return map_with_path(
        lambda path, leaf: strip(_param_spec(tuple(path.split("/")),
                                              tuple(leaf.shape), mesh), fs),
        shapes_tree)


# ---------------------------------------------------------------------------
# Batch / state specs
# ---------------------------------------------------------------------------

def batch_axis(mesh, global_batch: int):
    """Largest prefix of (pod, data) that divides global_batch."""
    axes = []
    size = 1
    for a in ("pod", "data"):
        if a in mesh.shape and global_batch % (size * mesh.shape[a]) == 0:
            axes.append(a)
            size *= mesh.shape[a]
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def train_batch_specs(mesh, global_batch: int, batch: Any) -> Any:
    BA = batch_axis(mesh, global_batch)
    return map_with_path(
        lambda _, leaf: P(*((BA,) + (None,) * (leaf.ndim - 1))), batch)


def train_state_specs(cfg: ModelConfig, mesh, state_shapes: Any) -> Any:
    """TrainState(params, opt(step,m,v), residuals) -> spec tree."""
    from repro_torch.optim import AdamWState
    from repro_torch.train.step import TrainState
    return TrainState(
        params=param_specs(cfg, mesh, state_shapes.params),
        opt=AdamWState(step=P(),
                       m=param_specs(cfg, mesh, state_shapes.opt.m),
                       v=param_specs(cfg, mesh, state_shapes.opt.v)),
        residuals=None if state_shapes.residuals is None
        else param_specs(cfg, mesh, state_shapes.residuals),
    )


def decode_state_specs(cfg: ModelConfig, mesh, state_shapes: Any,
                       global_batch: int, *,
                       kv_seq_axis: Optional[str] = None) -> Any:
    """DecodeState spec tree. Batch shards over data when divisible;
    otherwise the cache *sequence* axis shards over data (long-context SP).
    kv_seq_axis="model" additionally shards cache positions over TP ranks
    (GQA kv-heads < TP degree make head-sharding impossible; sequence
    sharding is the lever)."""
    from repro_torch.models.attention import KVCacheView
    from repro_torch.models.mamba import MambaCache
    from repro_torch.models.model import DecodeState
    from repro_torch.models.transformer import CrossCache

    BA = batch_axis(mesh, global_batch)
    seq_shard = "data" if BA is None and "data" in mesh.shape else None
    if kv_seq_axis and kv_seq_axis in mesh.shape and seq_shard is None:
        seq_shard = kv_seq_axis
    M = "model" if "model" in mesh.shape else None

    def walk(node, stacked: bool):
        lead = (None,) if stacked else ()
        if isinstance(node, KVCacheView):
            return KVCacheView(
                k=P(*lead, BA, seq_shard, None, None),
                v=P(*lead, BA, seq_shard, None, None),
                kv_pos=P(*lead, BA, seq_shard))
        if isinstance(node, MambaCache):
            hdim = node.state.shape[len(lead) + 1]
            h_ax = M if (M and hdim % mesh.shape["model"] == 0) else None
            return MambaCache(
                conv=P(*lead, BA, None, None),
                state=P(*lead, BA, h_ax, None, None))
        if isinstance(node, CrossCache):
            return CrossCache(k=P(*lead, BA, None, None, None),
                              v=P(*lead, BA, None, None, None))
        if isinstance(node, dict):
            return {k: walk(v, stacked or k in ("slots", "cross_slots"))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            return type(node)(walk(v, stacked) for v in node)
        # Leaves outside caches (cur_pos etc.): batch-sharded on axis 0.
        nd = getattr(node, "ndim", 0)
        return P(*((BA,) + (None,) * max(nd - 1, 0)))

    if not isinstance(state_shapes, DecodeState):
        raise TypeError(f"decode_state_specs: a DecodeState, got "
                        f"{type(state_shapes).__name__}")
    return DecodeState(caches=walk(state_shapes.caches, False),
                       cur_pos=P(BA))


# ---------------------------------------------------------------------------
# Per-device shards (in place of to_named / NamedSharding)
# ---------------------------------------------------------------------------

class Shard(NamedTuple):
    shape: Tuple[int, ...]     # the per-device block (ceil division)
    nbytes: int


def shard_shape(shape: Tuple[int, ...], spec: P, mesh) -> Tuple[int, ...]:
    """The per-device block of a ``shape`` array under ``spec``: each dim
    divided (rounded up, as a padded shard is) by the product of its
    entry's axis sizes; dims past the spec are whole."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    axes = _axes(mesh)
    out = []
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        size = 1 if e is None else math.prod(
            axes[a] for a in (e if isinstance(e, tuple) else (e,)))
        out.append(-(-dim // size))
    return tuple(out)


def per_device(shapes_tree: Any, specs_tree: Any, mesh) -> Dict[str, Shard]:
    """{leaf path: :class:`Shard`} of every leaf of ``shapes_tree`` (tensors,
    meta ones included) under the congruent ``specs_tree`` and ``mesh``."""
    specs = flatten(specs_tree)
    out = {}
    for path, leaf in flatten(shapes_tree).items():
        block = shard_shape(tuple(leaf.shape), specs[path], mesh)
        out[path] = Shard(block, math.prod(block) * leaf.element_size())
    return out


def per_device_bytes(shapes_tree: Any, specs_tree: Any, mesh) -> int:
    """Bytes one device holds of ``shapes_tree`` under ``specs_tree``."""
    return sum(s.nbytes for s in per_device(shapes_tree, specs_tree,
                                            mesh).values())


# ---------------------------------------------------------------------------
# Blocks on a process mesh
# ---------------------------------------------------------------------------

def _entry_axes(mesh, e) -> Tuple[str, ...]:
    return mesh.axes(e) if e is not None else ()


def _grid_view(x, spec: P, mesh, coords):
    """A view of ``x`` at the block of mesh position ``coords``, each split
    dim left as (the ``spec.own`` axes' positions..., block rows), and the
    block's shape with those merged. The specs' divisibility guard makes
    every block an exact slice."""
    y, merged = x, list(x.shape)
    # From the last dim down: splitting dim i leaves dims < i in place.
    for i in reversed(range(min(len(spec), x.ndim))):
        axes = _entry_axes(mesh, spec[i])
        if not axes:
            continue
        sizes = [mesh.shape[a] for a in axes]
        if x.shape[i] % math.prod(sizes):
            raise ValueError(f"dim {x.shape[i]} does not split over {axes}")
        b = x.shape[i] // math.prod(sizes)
        y = y.view(*y.shape[:i], *sizes, b, *y.shape[i + 1:])
        y = y[(slice(None),) * i + tuple(
            slice(None) if a in spec.own else coords[a] for a in axes)]
        merged[i] = b * math.prod(mesh.shape[a] for a in axes
                                  if a in spec.own)
    return y, tuple(merged)


def take_block(x, spec: P, mesh):
    """This rank's block of the whole leaf ``x`` under ``spec`` (a view
    where the block is one, else a copy)."""
    y, shape = _grid_view(x, spec, mesh, mesh.coords)
    return y.reshape(shape)


def block_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shape of every rank's block of a ``shape`` leaf under ``spec``."""
    import torch
    meta = torch.empty(shape, device="meta")
    return _grid_view(meta, spec, mesh,
                      {a: 0 for a in mesh.axis_names})[1]


def leaf_shape(block: Tuple[int, ...], spec: P, mesh) -> Tuple[int, ...]:
    """The whole leaf's shape from its block's under ``spec``."""
    out = list(block)
    for i in range(min(len(spec), len(out))):
        out[i] *= math.prod(mesh.shape[a]
                            for a in _entry_axes(mesh, spec[i])
                            if a not in spec.own)
    return tuple(out)


def gather_leaf(block, spec: P, mesh):
    """The whole leaf from this rank's ``block`` under ``spec`` (no
    ``own`` axes): an all-gather along each split dim's axes, dim by dim."""
    import torch
    from .shardlib import all_gather
    x = block
    for i in range(min(len(spec), x.ndim)):
        axes = _entry_axes(mesh, spec[i])
        if axes and mesh.size(axes) > 1:
            x = torch.cat(all_gather(x, axes, mesh), dim=i)
    return x


def replicas(spec: P, mesh) -> int:
    """How many ranks hold each block of a leaf under ``spec``: the
    product of the axes it neither splits over nor owns."""
    used = {a for e in spec for a in _entry_axes(mesh, e)} | set(spec.own)
    return math.prod(n for a, n in mesh.shape.items() if a not in used)


def assemble(blocks, shape, spec: P, mesh):
    """The whole leaf from every rank's block, ``blocks[r]`` being world
    rank ``r``'s (host tensors). With ``spec.own``, a list of leaves, one
    per position along those axes (mesh order), each from the blocks of
    the ranks at that position."""
    import numpy as np
    import torch
    grid = np.arange(mesh.devices.size).reshape(mesh.devices.shape)
    own = mesh.axes(spec.own)
    out = []
    for pos in np.ndindex(*[mesh.shape[a] for a in own]):
        full = torch.empty(shape, dtype=blocks[0].dtype)
        for r in range(grid.size):
            coords = dict(zip(mesh.axis_names,
                              map(int, np.unravel_index(r, grid.shape))))
            if any(coords[a] != p for a, p in zip(own, pos)):
                continue
            view, _ = _grid_view(full, spec, mesh, coords)
            view.copy_(blocks[r].reshape(view.shape))
        out.append(full)
    return out if own else out[0]


def is_expert_leaf(path: str, spec: P) -> bool:
    """An MoE expert stack (E, ., .) split over ``model`` on its experts:
    expert parallelism keeps that slice (the rank's experts) in compute."""
    return (path.rsplit("/", 1)[-1] in ("w_gate", "w_up", "w_down")
            and len(spec) == 3 and spec[0] == "model")


def computed_on_model(cfg: ModelConfig, path: str, spec: P) -> bool:
    """Whether the sharded step computes with the parameter leaf at
    ``path`` as this rank's block on ``model`` (gathered over the batch
    axes only, its gradient left a block there), the one rule for the step
    and the model:

    * an expert stack split over ``model`` (expert parallelism);
    * tensor parallelism, Megatron's split, where ``spec`` splits the leaf
      over ``model`` (``_param_spec`` drops the axis where it does not
      divide): attention's ``wq`` and ``bq`` over heads (column) and
      ``wo`` (row), MLA's ``q_up`` and ``kv_up`` over heads (column) and
      its ``wo`` (row), an encoder-decoder's cross-attention (``cross``)
      as attention; the dense MLP's and an MoE layer's shared expert's
      ``w_gate`` and ``w_up`` over ``d_ff`` (column) and ``w_down`` (row);
      the embedding and the unembedding over ``vocab``. An
      encoder-decoder's encoder stack is named as the decoder's.

    Every other leaf is replicated on ``model`` by its spec (MLA's
    ``q_down`` and ``kv_down``, ``wk``/``wv``, the router, norms, Mamba's
    leaves). The model takes a leaf it finds shorter than the config's
    width as its block (``shardlib.model_block``)."""
    if is_expert_leaf(path, spec):
        return True
    if not any("model" in (e if isinstance(e, tuple) else (e,))
               for e in spec):
        return False
    parts = path.split("/")
    if parts[-1] in ("embedding", "unembed"):
        return parts[:-1] == ["embed"]
    parent = parts[-2] if len(parts) > 1 else ""
    if parent in ("mixer", "cross"):
        return parts[-1] in ("wq", "bq", "wo", "q_up", "kv_up")
    if parent == "shared" and len(parts) > 2 and parts[-3] == "ffn":
        parent = "ffn"
    return (parent == "ffn" and len(spec) == 2
            and parts[-1] in ("w_gate", "w_up", "w_down"))


def train_state_block_specs(cfg: ModelConfig, mesh, state_shapes: Any,
                            compress_axis: Optional[str] = "pod") -> Any:
    """The specs of a rank's blocks of a :class:`TrainState` on a process
    mesh: :func:`train_state_specs`, except the error-feedback residuals.
    Each position along ``compress_axis`` keeps its own residual of what
    it sends across the axis: for every position's share of the leaf
    along it, since each sends them all. So a residual's spec owns the
    axis."""
    specs = train_state_specs(cfg, mesh, state_shapes)
    if specs.residuals is None or compress_axis not in mesh.shape:
        return specs
    res = map_with_path(lambda _, sp: P(*sp, own=(compress_axis,)),
                        specs.residuals)
    return specs._replace(residuals=res)
