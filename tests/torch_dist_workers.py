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
# The sharded train step, checkpoints, elastic restore
# ---------------------------------------------------------------------------

def _step_cfg(grad_clip=1.0):
    from repro_torch.train import TrainConfig
    return TrainConfig(optimizer=optim.AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=6, weight_decay=0.1,
        grad_clip=grad_clip))


def _state_from(state_np, cfg):
    from repro_torch.models import train_state_from_jax
    return train_state_from_jax(state_np, cfg, "cpu")


def sharded_steps(rank, world, *, cases, ckpt_dir):
    """For each case (arch, capacity factor, the reference's state as
    numpy, the global batches): the sharded step on ``data`` 2 x ``model``
    2 from the rank's blocks of that state and its rows of each batch.
    Returns the metrics of each step and the rank's blocks after the last;
    the first case's state is then saved under ``ckpt_dir`` as step 3."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.train import (local_batch, make_train_step,
                                   state_block_specs, state_blocks)
    mesh = _mesh(2, 2)
    tcfg = _step_cfg()
    out = []
    for i, (arch, cap, state_np, batches) in enumerate(cases):
        cfg = config(arch, capacity_factor=cap)
        specs = state_block_specs(cfg, mesh, tcfg)
        state = state_blocks(_state_from(state_np, cfg), cfg, tcfg, mesh)
        step = make_train_step(cfg, tcfg)
        metrics = []
        with shardlib.use_mesh(mesh, sh.activation_rules(mesh)):
            for b in batches:
                lb = local_batch({k: torch.as_tensor(v)
                                  for k, v in b.items()}, mesh)
                state, m = step(state, lb)
                metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            Checkpointer(ckpt_dir).save(3, state, extra={"case": arch},
                                        mesh=mesh, specs=specs)
        out.append({"metrics": metrics, "blocks": _blocks(state),
                    "coords": dict(mesh.coords)})
    return out


def compressed_and_elastic(rank, world, *, arch, state_np, batches,
                           ckpt_dir, jax_ckpt_dir, step_batch):
    """On ``pod`` 2: the sharded step with ``compress_pod_axis``. Then on
    ``data`` 1 x ``model`` 2: ``survive_shrink`` of ``ckpt_dir`` (its
    first mesh refused) and one step on ``step_batch``; and
    ``reshard_checkpoint`` of a checkpoint the JAX package wrote."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.fault import (reshard_checkpoint,
                                               survive_shrink)
    from repro_torch.train import (TrainConfig, local_batch, shard_state,
                                   state_shapes, train_step)
    cfg = config(arch)
    out = {}
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
