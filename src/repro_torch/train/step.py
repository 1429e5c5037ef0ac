"""Train step: microbatched gradient accumulation, AdamW, optional cross-pod
gradient compression, and the sharded step on a process mesh.

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

Under a mesh backed by process groups (``launch.mesh.make_process_mesh``)
the same call is the sharded step, SPMD over the ranks (:func:`_sharded`):
the state holds the rank's block of every leaf
(:func:`shard_state`, under ``distributed.sharding.train_state_block_specs``)
and the batch its rows (:func:`local_batch`). ``compress_pod_axis`` names
the axis whose gradient reduction is the EF-int8 all-reduce
(``optim.compress``); it needs such a mesh, as the reference's needs its
``shard_map`` over pods (ROADMAP Queue A item 15(d), closed).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import optim
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import shardlib
from repro_torch.distributed import sharding as sh
from repro_torch.models.model import loss_fn, param_shapes
from repro_torch.obs.trace import region
from repro_torch.tree import flatten, map_with_path, tree_map


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
    residuals = None
    if tcfg.compress_pod_axis:
        residuals = optim.init_residuals(params)
    return TrainState(params=params, opt=optim.init(params),
                      residuals=residuals)


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


def _value_and_grad(params, batch, cfg: ModelConfig, cast_bf16: bool,
                    denom=None):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``: gradients of
    the parameters' own dtype, a tree of their structure (zeros for a leaf
    the loss does not reach)."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with region("train.forward"):
            p_in = _cast_params(leaves, cfg.cdtype) if cast_bf16 else leaves
            loss, metrics = loss_fn(p_in, batch, cfg, denom=denom)
        flat = flatten(leaves)
        with region("train.backward"):
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
    with region("train.accumulate"):
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
    loss_sum = None
    for i in range(microbatches):
        loss, _, grads = _value_and_grad(
            params, {k: v[i] for k, v in mb.items()}, cfg, cast_bf16)
        with region("train.accumulate"):
            acc = tree_map(torch.add, acc, grads)
        del grads
        loss_sum = loss if loss_sum is None else loss_sum + loss
    with region("train.accumulate"):
        grads = tree_map(lambda g: g / microbatches, acc)
    return grads, {"loss": loss_sum / microbatches}


def train_step(state: TrainState, batch, cfg: ModelConfig,
               tcfg: TrainConfig) -> Tuple[TrainState, dict]:
    mesh = shardlib.process_mesh()
    if mesh is not None:
        return _sharded(state, batch, cfg, tcfg, mesh)
    if tcfg.compress_pod_axis:
        raise ValueError(f"compress_pod_axis={tcfg.compress_pod_axis!r} "
                         "reduces over that axis of a process mesh "
                         "(launch.mesh.make_process_mesh); none is set")
    grads, metrics = grads_and_metrics(state.params, batch, cfg,
                                       tcfg.microbatches,
                                       cast_bf16=tcfg.cast_params_bf16)
    new_params, new_opt, opt_metrics = optim.apply(
        tcfg.optimizer, state.params, grads, state.opt)
    del grads
    metrics = {**metrics, **opt_metrics}
    return TrainState(new_params, new_opt, state.residuals), metrics


# ---------------------------------------------------------------------------
# The sharded step on a process mesh
# ---------------------------------------------------------------------------

def state_shapes(cfg: ModelConfig, tcfg: TrainConfig) -> TrainState:
    """The whole :class:`TrainState` as ``meta`` tensors (shapes and
    dtypes): what a checkpoint's restore fills."""
    params = param_shapes(cfg)
    fp32 = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                 device="meta")
    return TrainState(
        params,
        optim.AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                         tree_map(fp32, params), tree_map(fp32, params)),
        tree_map(fp32, params) if tcfg.compress_pod_axis else None)


def state_block_specs(cfg: ModelConfig, mesh, tcfg: TrainConfig):
    """The spec tree of a rank's :class:`TrainState` blocks on ``mesh``."""
    key = (cfg, tcfg.compress_pod_axis)
    cache = mesh.__dict__.setdefault("_state_specs", {})
    if key not in cache:
        cache[key] = sh.train_state_block_specs(
            cfg, mesh, state_shapes(cfg, tcfg), tcfg.compress_pod_axis)
    return cache[key]


def shard_state(params, cfg: ModelConfig, tcfg: TrainConfig,
                mesh) -> TrainState:
    """A fresh :class:`TrainState` of this rank's blocks, from the whole
    ``params`` (the same on every rank): its parameter blocks (copies),
    zero moments and residuals of the blocks' shapes, step 0."""
    specs = state_block_specs(cfg, mesh, tcfg)
    ps = flatten(specs.params)
    blocks = map_with_path(
        lambda k, p: sh.take_block(p, ps[k], mesh).clone(), params)
    residuals = None
    if tcfg.compress_pod_axis:
        rs = flatten(specs.residuals)
        residuals = map_with_path(
            lambda k, p: torch.zeros(sh.block_shape(p.shape, rs[k], mesh),
                                     dtype=torch.float32, device=p.device),
            params)
    return TrainState(blocks, optim.init(blocks), residuals)


def state_blocks(state: TrainState, cfg: ModelConfig, tcfg: TrainConfig,
                 mesh) -> TrainState:
    """This rank's blocks (copies) of a whole :class:`TrainState`."""
    specs = flatten(state_block_specs(cfg, mesh, tcfg))
    return map_with_path(
        lambda k, v: sh.take_block(v, specs[k], mesh).clone(), state)


def local_batch(batch, mesh):
    """This rank's rows of the global ``batch``: the batch splits over
    every batch axis (``train_batch_specs``); ranks along ``model`` take
    the same rows."""
    b = next(iter(batch.values())).shape[0]
    fs = sh.fsdp_axes(mesh)
    got = sh.batch_axis(mesh, b)
    if mesh.axes(got) != fs:
        raise ValueError(f"a global batch of {b} rows does not split over "
                         f"the batch axes {fs} of {mesh!r}")
    specs = sh.train_batch_specs(mesh, b, batch)
    return {k: sh.take_block(v, specs[k], mesh) for k, v in batch.items()}


def _mask_count(batch) -> torch.Tensor:
    mask = batch.get("loss_mask")
    if mask is None:
        return torch.tensor(float(batch["labels"].numel()),
                            device=batch["labels"].device)
    return mask.float().sum()


def microbatch_rows(rows: int, n: int, ranks: int,
                    index: int) -> List[Tuple[int, int]]:
    """The rows ``[start, stop)`` of a batch of ``rows`` that rank
    ``index`` of the ``ranks`` splitting it computes in each of ``n``
    microbatches: microbatch ``i`` holds rows ``[i rows/n, (i+1) rows/n)``,
    as the reference's scan slices the global batch, and the rank its
    block ``index`` of those, as GSPMD reshards the slice onto the batch
    spec."""
    if rows % (n * ranks):
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{n} microbatches over {ranks} ranks")
    per, size = rows // (n * ranks), rows // n
    return [(i * size + index * per, i * size + (index + 1) * per)
            for i in range(n)]


def _microbatches(batch, n: int, mesh, axes):
    """This rank's rows of each of ``n`` microbatches of the batch split
    over ``axes`` (each rank holding its rows of it, ``batch``): the ranks'
    rows all-gathered along ``axes`` and cut by :func:`microbatch_rows`."""
    ranks = mesh.size(axes)
    rows = next(iter(batch.values())).shape[0] * ranks
    cuts = microbatch_rows(rows, n, ranks, mesh.index(axes))
    if n == 1:
        return [batch]
    if ranks > 1:
        batch = {k: torch.cat(shardlib.all_gather(v, axes, mesh))
                 for k, v in batch.items()}
    return [{k: v[a:b] for k, v in batch.items()} for a, b in cuts]


def _sharded_grads(full, batch, cfg: ModelConfig, tcfg: TrainConfig, mesh,
                   sum_axes):
    """Gradients of this rank's share of the loss at the gathered
    parameters, and the metrics of the batch across ``sum_axes``.

    The token means divide by the mask count summed over ``sum_axes``,
    never a mean of per-rank means: the rank's gradients then sum to the
    batch's. The auxiliary loss is already a mean over them (``pmean`` in
    ``moe_ffn``). Microbatches are the reference's slices of the batch
    over ``sum_axes`` (:func:`_microbatches`; over ``compress_pod_axis``
    each pod's rows are its own batch)."""
    n = tcfg.microbatches
    acc, metrics = None, None
    for b in _microbatches(batch, n, mesh, sum_axes):
        denom = shardlib.all_reduce_(_mask_count(b), sum_axes, mesh) \
            if sum_axes else None
        _, m, grads = _value_and_grad(full, b, cfg, tcfg.cast_params_bf16,
                                      denom=denom)
        aux = m["aux"]
        parts = torch.stack([m["loss"] - aux, m["ce"], m["z_loss"]])
        if sum_axes:
            shardlib.all_reduce_(parts, sum_axes, mesh)
        m = {"ce": parts[1], "z_loss": parts[2], "aux": aux,
             "loss": parts[0] + aux}
        if n == 1:
            return grads, m
        with region("train.accumulate"):
            acc = tree_map(lambda g: g.float(), grads) if acc is None \
                else tree_map(torch.add, acc, grads)
        metrics = m["loss"] if metrics is None else metrics + m["loss"]
    with region("train.accumulate"):
        grads = tree_map(lambda g: g / n, acc)
    return grads, {"loss": metrics / n}


def _onto_block(g, spec, axes, mesh):
    """The gradient ``g`` of a leaf gathered whole along ``spec``'s axes,
    summed over the batch ``axes``: reduce-scattered onto this rank's
    block of the dim ``spec`` splits over them, or all-reduced whole where
    no dim does. Returns it and the spec of what is left to cut
    (``spec`` less ``axes``); axes of that dim's entry outside ``axes``
    (``pod`` under EF-int8) stay whole, each position's share in turn."""
    for i, e in enumerate(spec):
        ax = mesh.axes(e)
        if not set(ax) & set(axes):
            continue
        outer = ax[:len(ax) - len(axes)]
        if ax[len(outer):] != mesh.axes(axes):
            raise ValueError(f"{spec} splits dim {i} over {ax}, not over "
                             f"the batch axes {axes} last")
        parts = g.unflatten(i, (mesh.size(outer), -1))
        mesh.count("grads_reduce_scatter", g.numel() * g.element_size())
        g = shardlib.reduce_scatter(parts, axes, i + 1, mesh).flatten(i,
                                                                      i + 1)
        return g, sh.strip(spec, axes)
    mesh.count("grads_all_reduce", g.numel() * g.element_size())
    return shardlib.all_reduce_(g, axes, mesh), sh.strip(spec, axes)


def _sharded(state: TrainState, batch, cfg: ModelConfig, tcfg: TrainConfig,
             mesh) -> Tuple[TrainState, dict]:
    """One step on this rank's blocks and rows (see the module).

    1. Each parameter leaf is all-gathered over the axes of its spec. A
       leaf ``sharding.computed_on_model`` names keeps its ``model`` block
       and is gathered over the batch axes only: an expert stack (the
       rank's experts, which expert-parallel ``moe_ffn`` takes as they
       are) and the tensor-parallel dense leaves (the model splits its
       products over ``model``). Any other leaf is gathered whole.
    2. Forward and backward on the rank's rows, in the reference's
       microbatches.
    3. Gradients are summed over the batch axes (in fp32): reduce-scattered
       onto the rank's block of the dim the leaf's spec splits over them,
       all-reduced whole where none does. Over ``compress_pod_axis``, the
       EF-int8 mean instead: each pod is then a replica whose loss is its
       own rows' mean, as inside the reference's ``shard_map`` over pods,
       and each rank compresses its block of every pod's share along that
       axis with its own residual.
    4. Each gradient is cut to the rank's block; AdamW runs on the blocks,
       clipped by the global norm of the reduced gradients.

    ``mesh.traffic`` counts the bytes each rank received in the gathers
    and put into each form of gradient reduction.
    """
    specs = state_block_specs(cfg, mesh, tcfg)
    pspecs = flatten(specs.params)
    pod = tcfg.compress_pod_axis
    if pod and (pod not in mesh.shape or state.residuals is None):
        raise ValueError(f"compress_pod_axis={pod!r}: the mesh needs that "
                         "axis and the state its residuals (shard_state)")
    sum_axes = tuple(a for a in sh.fsdp_axes(mesh) if a != pod)

    def computed(k):
        """The spec of the part of leaf ``k`` the rank computes with: the
        leaf's, less ``model`` where the rank computes with its block."""
        if sh.computed_on_model(cfg, k, pspecs[k]):
            return sh.strip(pspecs[k], ("model",))
        return pspecs[k]

    def gather(k, b):
        g = sh.gather_leaf(b, computed(k), mesh)
        mesh.count("params_gathered",
                   (g.numel() - b.numel()) * b.element_size())
        return g

    full = map_with_path(gather, state.params)
    rules = dict(shardlib.current_rules() or sh.activation_rules(mesh),
                 batch=sum_axes or None)
    with shardlib.use_mesh(mesh, rules):
        grads, metrics = _sharded_grads(full, batch, cfg, tcfg, mesh,
                                        sum_axes)
    del full

    flat = flatten(grads)
    del grads
    reduce = sum_axes and mesh.size(sum_axes) > 1
    out, left = {}, {}
    for k in list(flat):
        # One leaf at a time, its whole gradient gone before the next.
        g, left[k] = flat.pop(k), computed(k)
        if reduce:
            g, left[k] = _onto_block(g.float(), left[k], sum_axes, mesh)
        out[k] = g
    residuals = state.residuals
    if pod:
        # Each rank sends its block of every pod's share of the leaf along
        # the pod axis, compressed against its own residual; then keeps
        # its pod's share of the mean.
        cols = {k: sh.take_block(g, sh.P(*left[k], own=(pod,)), mesh)
                for k, g in out.items()}
        reduced, residuals = optim.compressed_psum_tree(
            map_with_path(lambda k, _: cols[k], state.params),
            state.residuals, pod)
        others = tuple(a for a in mesh.axis_names if a != pod)
        out = {k: sh.take_block(g, sh.strip(pspecs[k], others), mesh)
               for k, g in flatten(reduced).items()}
        metrics = {k: shardlib.all_reduce_(v.clone(), pod, mesh)
                   / mesh.size(pod) for k, v in metrics.items()}
    else:
        for k, g in out.items():
            # A copy of a smaller block, so the whole gradient goes now
            # (not after AdamW).
            blk = sh.take_block(g, left[k], mesh)
            out[k] = blk.clone() if blk.numel() < g.numel() else blk
    del flat

    # Global norm: every block once, its copies on other ranks not again.
    sq = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for k, g in out.items():
        g32 = g.reshape(-1).float()
        sq = sq + torch.dot(g32, g32) / sh.replicas(pspecs[k], mesh)
    gnorm = shardlib.all_reduce_(sq, mesh.axis_names, mesh).sqrt()
    block_grads = map_with_path(lambda k, _: out[k], state.params)
    new_params, new_opt, opt_metrics = optim.apply(
        tcfg.optimizer, state.params, block_grads, state.opt, gnorm=gnorm)
    return (TrainState(new_params, new_opt, residuals),
            {**metrics, **opt_metrics})


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """``step(state, batch) -> (state, metrics)`` for ``cfg`` and ``tcfg``
    (the reference's ``jit_train_step``; nothing is compiled)."""
    return functools.partial(train_step, cfg=cfg, tcfg=tcfg)
