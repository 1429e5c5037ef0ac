"""Rank programs for the port's multi-process tests (gloo on the CPU).

Each function runs on every rank of a world that
``repro_torch.distributed.world.run_world`` starts, after the process
group is up, and returns what the test holds: plain numbers and CPU
tensors. They import neither ``jax`` nor ``repro``: the tests compute the
reference and pass it in, or hold what comes back against it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.distributed import shardlib
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models.moe import moe_ffn
from repro_torch.tree import flatten


def config(arch: str, compute: str = "float32", capacity_factor=None):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype=compute)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _mesh(data, model, pod=0):
    torch.set_num_threads(1)
    return make_process_mesh(data, model, pod, backend="gloo", device="cpu")


def _blocks(tree):
    return {k: v.detach().clone() for k, v in flatten(tree).items()}


# ---------------------------------------------------------------------------
# Collectives: EF-int8, meshes, expert-parallel MoE
# ---------------------------------------------------------------------------

def ef_and_mesh(rank, world, *, grads, residuals, converge):
    """On ``pod`` 2: the EF-int8 all-reduce of rank ``rank``'s leaves
    (each leaf alone, and the tree at once), the 200-step error-feedback
    property, and what ``make_process_mesh`` refuses."""
    from repro_torch.optim import compress
    mesh = _mesh(1, 1, pod=2)
    out = {}
    with shardlib.use_mesh(mesh):
        g = [torch.as_tensor(x) for x in grads[rank]]
        r = [torch.as_tensor(x) for x in residuals[rank]]
        out["leaf"] = [compress.compress_allreduce_leaf(a, b, "pod")
                       for a, b in zip(g, r)]
        before = dict(compress.WIRE_BYTES)
        tree = compress.compressed_psum_tree(
            {str(i): a for i, a in enumerate(g)},
            {str(i): b for i, b in enumerate(r)}, "pod")
        out["tree"] = tree
        out["wire"] = {k: compress.WIRE_BYTES[k] - before[k]
                       for k in before}
        # Error feedback: every rank sends the same gradient, so the mean
        # is what each sent; over 200 steps it averages to the gradient.
        x = torch.as_tensor(converge)
        res = torch.zeros_like(x)
        total = torch.zeros_like(x)
        for _ in range(200):
            red, res = compress.compress_allreduce_leaf(x, res, "pod")
            total += red
        out["converge"] = (total / 200, res)
    refused = {}
    for name, kw in (("size", dict(data=2, model=2, backend="gloo")),
                     ("backend", dict(data=1, model=2, backend="nccl"))):
        try:
            make_process_mesh(device="cpu", **kw)
        except ValueError as e:
            refused[name] = str(e)
    out["refused"] = refused
    out["groups"] = {"model_index": mesh.index("model"),
                     "pod_index": mesh.index("pod"),
                     "pod_size": mesh.size(("pod", "data"))}
    return out


def moe_ep(rank, world, *, arch, capacity_factor, data, model, params, x,
           want_grads):
    """Expert-parallel ``moe_ffn`` on ``data`` x ``model``: each rank its
    rows of ``x`` (B split over ``data``) and the weights whole (it takes
    its experts). With ``want_grads``, the gradients of ``sum(y * w) +
    aux`` too, and the one-process ``moe_ffn``'s on the whole ``x``."""
    cfg = config(arch, capacity_factor=capacity_factor)
    mesh = _mesh(data, model)
    params = {k: torch.as_tensor(v) for k, v in params.items()}
    x = torch.as_tensor(x)
    rows = x.shape[0] // data
    d0 = mesh.coords["data"] * rows
    xl = x[d0:d0 + rows]
    w = torch.linspace(-1, 1, x[..., :1].numel()).reshape(x.shape[:-1] +
                                                          (1,))

    def run(xin, win, p):
        xin = xin.clone().requires_grad_(want_grads)
        leaves = {k: v.clone().requires_grad_(want_grads)
                  for k, v in p.items()}
        y, aux, metrics = moe_ffn(leaves, xin, cfg, cfg.act_fn)
        out = {"y": y.detach(), "aux": aux.detach(),
               "dropped": metrics["moe_dropped"].detach()}
        if want_grads:
            ((y * win).sum() + aux).backward()
            out["grads"] = {"x": xin.grad, **{k: v.grad
                                              for k, v in leaves.items()}}
        return out

    from repro_torch.distributed.sharding import activation_rules
    with shardlib.use_mesh(mesh, activation_rules(mesh)):
        ep = run(xl, w[d0:d0 + rows], params)
    out = {"ep": ep, "coords": dict(mesh.coords)}
    if want_grads:
        out["one"] = run(x, w, params)
        out["remat"] = _remat_off_mesh(cfg, mesh)
    return out


def _remat_off_mesh(cfg, mesh):
    """The model's gradients under remat with expert parallelism, the
    backward run inside the mesh, after it, and on another thread (as
    autograd's thread for the card runs it): the recompute must see the
    forward's mesh each time."""
    import threading

    from repro_torch.models import init_params, loss_fn
    from repro_torch.tree import tree_map
    params = init_params(0, cfg, "cpu")
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}

    def grads(where):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with shardlib.use_mesh(mesh, sh.activation_rules(mesh)):
            loss, _ = loss_fn(leaves, batch, cfg)
            if where == "inside":
                loss.backward()
        if where == "after":
            loss.backward()
        elif where == "thread":
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join()
        return {k: v.grad for k, v in flatten(leaves).items()}

    return {w: grads(w) for w in ("inside", "after", "thread")}


# ---------------------------------------------------------------------------
# Reduce-scatter onto blocks
# ---------------------------------------------------------------------------

def reduce_scatter_blocks(rank, world, *, shape):
    """On a world of 4: ``shardlib.reduce_scatter`` against all-reduce then
    ``take_block``, for each (mesh, batch axes) case and FSDP dim 0, 1, 2
    (random values where two ranks lie along the axes, integer values,
    whose sums are exact in any order, where four do); and the sharded
    step's ``_onto_block`` in the EF-int8 layout (``pod`` owned) against
    the same on pod 2 x data 2."""
    from repro_torch.train.step import _onto_block
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(rank)
    out = {}
    meshes = {"pod2_data2": (2, 1, 2), "pod2_model2": (1, 2, 2),
              "data2_model2": (2, 2, 0)}
    cases = (("pod2_data2", ("data",)), ("pod2_data2", ("pod", "data")),
             ("pod2_model2", ("pod", "data")), ("data2_model2", ("data",)))
    built = {name: make_process_mesh(*dims, backend="gloo", device="cpu")
             for name, dims in meshes.items()}
    for name, axes in cases:
        mesh = built[name]
        ints = mesh.size(axes) > 2
        for dim in range(3):
            t = torch.randn(shape, generator=g)
            if ints:
                t = torch.randint(-64, 64, shape, generator=g).float()
            entry = axes if len(axes) > 1 else axes[0]
            spec = sh.P(*[entry if i == dim else None for i in range(3)])
            got = shardlib.reduce_scatter(t, axes, dim, mesh)
            want = sh.take_block(shardlib.all_reduce_(t.clone(), axes, mesh),
                                 spec, mesh)
            out[(name, axes, dim)] = (got, want)
    mesh = built["pod2_data2"]
    for dim in range(3):
        t = torch.randn(shape, generator=g)
        spec = sh.P(*[("pod", "data") if i == dim else None
                      for i in range(3)])
        got, left = _onto_block(t.clone(), spec, ("data",), mesh)
        got = sh.take_block(got, sh.P(*left, own=("pod",)), mesh)
        want = sh.take_block(shardlib.all_reduce_(t.clone(), "data", mesh),
                             sh.P(*spec, own=("pod",)), mesh)
        out[("ef", ("data",), dim)] = (got, want)
    return out


# ---------------------------------------------------------------------------
# The sharded train step, checkpoints, elastic restore
# ---------------------------------------------------------------------------

class _Recording:
    """Within its ``with``: the shapes of the leaves the sharded step
    computes with (each call's, by path) and the (query heads, KV heads)
    of every flash call."""

    def __enter__(self):
        import sys

        from repro_torch.kernels import ops
        self.step = sys.modules["repro_torch.train.step"]
        self.ops = ops
        self.leaves, self.flash = [], []
        self._vg, self._flash = self.step._value_and_grad, \
            ops.flash_attention_op

        def value_and_grad(params, *args, **kwargs):
            self.leaves.append({k: tuple(v.shape)
                                for k, v in flatten(params).items()})
            return self._vg(params, *args, **kwargs)

        def flash(q, k, v, **kwargs):
            self.flash.append((q.shape[2], k.shape[2]))
            return self._flash(q, k, v, **kwargs)
        self.step._value_and_grad = value_and_grad
        ops.flash_attention_op = flash
        return self

    def __exit__(self, *exc):
        self.step._value_and_grad = self._vg
        self.ops.flash_attention_op = self._flash

def _step_cfg(grad_clip=1.0):
    from repro_torch.train import TrainConfig
    return TrainConfig(optimizer=optim.AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=6, weight_decay=0.1,
        grad_clip=grad_clip))


def _state_from(state_np, cfg):
    from repro_torch.models import train_state_from_jax
    return train_state_from_jax(state_np, cfg, "cpu")


def _steps(state, batches, cfg, tcfg, mesh):
    """The sharded step on the rank's rows of each global batch: the
    state, each step's metrics, and what the first step computed with
    (:class:`_Recording`)."""
    from repro_torch.train import local_batch, make_train_step
    step = make_train_step(cfg, tcfg)
    metrics = []
    with shardlib.use_mesh(mesh, sh.activation_rules(mesh)):
        for i, b in enumerate(batches):
            lb = local_batch({k: torch.as_tensor(v) for k, v in b.items()},
                             mesh)
            if i == 0:
                with _Recording() as rec:
                    state, m = step(state, lb)
            else:
                state, m = step(state, lb)
            metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, {"leaves": rec.leaves[0], "flash": rec.flash}


def sharded_steps(rank, world, *, cases, ckpt_dir, data=2, model=2):
    """For each case (arch, capacity factor, the reference's state as
    numpy, the global batches): the sharded step on ``data`` x ``model``
    from the rank's blocks of that state and its rows of each batch.
    Returns the metrics of each step, the rank's blocks after the last,
    what its first step computed with and the bytes its steps moved by
    kind (``Mesh.traffic``); with ``ckpt_dir``, the first case's state is
    then saved there as step 3."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.train import state_block_specs, state_blocks
    mesh = _mesh(data, model)
    tcfg = _step_cfg()
    out = []
    for i, (arch, cap, state_np, batches) in enumerate(cases):
        cfg = config(arch, capacity_factor=cap)
        specs = state_block_specs(cfg, mesh, tcfg)
        state = state_blocks(_state_from(state_np, cfg), cfg, tcfg, mesh)
        before = dict(mesh.traffic)
        state, metrics, computed = _steps(state, batches, cfg, tcfg, mesh)
        traffic = {k: v - before.get(k, 0) for k, v in mesh.traffic.items()}
        if i == 0 and ckpt_dir:
            Checkpointer(ckpt_dir).save(3, state, extra={"case": arch},
                                        mesh=mesh, specs=specs)
        out.append({"metrics": metrics, "blocks": _blocks(state),
                    "coords": dict(mesh.coords), "computed": computed,
                    "traffic": traffic})
    return out


def two_rank_steps(rank, world, *, arch, state_np, batches, ckpt_dir,
                   jax_ckpt_dir, step_batch, mb_batches):
    """On ``data`` 2: the sharded step at ``microbatches`` 2 from
    ``state_np`` on ``mb_batches``, and the ``ValueError`` of a batch that
    does not split into 3 microbatches over 2 ranks. On ``pod`` 2: the
    sharded step with ``compress_pod_axis``. Then on ``data`` 1 x ``model``
    2: ``survive_shrink`` of ``ckpt_dir`` (its first mesh refused) and one
    step on ``step_batch``; and ``reshard_checkpoint`` of a checkpoint the
    JAX package wrote."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.fault import (reshard_checkpoint,
                                               survive_shrink)
    from repro_torch.train import (TrainConfig, local_batch, shard_state,
                                   state_blocks, state_shapes, train_step)
    cfg = config(arch)
    out = {}
    tcfg = dataclasses.replace(_step_cfg(), microbatches=2)
    mesh = _mesh(2, 1)
    state = state_blocks(_state_from(state_np, cfg), cfg, tcfg, mesh)
    state, metrics, _ = _steps(state, mb_batches, cfg, tcfg, mesh)
    out["microbatched"] = {"metrics": metrics, "blocks": _blocks(state)}
    try:
        _steps(state, mb_batches[:1], cfg,
               dataclasses.replace(tcfg, microbatches=3), mesh)
    except ValueError as e:
        out["microbatched"]["refused"] = str(e)
    # No clipping: the clip scale's global norm sums in another order on
    # the blocks, which would move the parameters by ulps.
    tcfg = dataclasses.replace(_step_cfg(grad_clip=0.0),
                               compress_pod_axis="pod")
    mesh = _mesh(1, 1, pod=2)
    whole = _state_from(state_np, cfg)
    state = shard_state(whole.params, cfg, tcfg, mesh)
    out["res_shapes"] = {k: tuple(v.shape)
                         for k, v in flatten(state.residuals).items()}
    metrics = []
    with shardlib.use_mesh(mesh, sh.activation_rules(mesh)):
        for b in batches:
            lb = local_batch({k: torch.as_tensor(v) for k, v in b.items()},
                             mesh)
            state, m = train_step(state, lb, cfg, tcfg)
            metrics.append({k: float(v) for k, v in m.items()})
    out["compressed"] = {"metrics": metrics, "blocks": _blocks(state),
                         "coords": dict(mesh.coords)}

    plain = TrainConfig()
    attempts = []

    def make_mesh(attempt):
        attempts.append(attempt)
        if attempt == 0:
            raise RuntimeError("the first topology lost a rank")
        return _mesh(1, 2)

    shapes = state_shapes(cfg, plain)
    state, extra, mesh = survive_shrink(Checkpointer(ckpt_dir), cfg, shapes,
                                        make_mesh)
    out["elastic"] = {"attempts": attempts, "extra": extra,
                      "blocks": _blocks(state),
                      "coords": dict(mesh.coords)}
    with shardlib.use_mesh(mesh, sh.activation_rules(mesh)):
        lb = local_batch({k: torch.as_tensor(v)
                          for k, v in step_batch.items()}, mesh)
        _, m = train_step(state, lb, cfg, _step_cfg())
    out["elastic"]["next"] = {k: float(v) for k, v in m.items()}
    state, _ = reshard_checkpoint(Checkpointer(jax_ckpt_dir), 2, cfg, mesh,
                                  shapes)
    out["from_jax"] = _blocks(state)
    return out
