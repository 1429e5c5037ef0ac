"""Training mixes: the program's ``make_train_step`` over the mix's batches.

Set-up builds one train state from the benchmark's seeded weights and
drives it through the mix's ``check_steps`` first steps (the same step
function and feed as the window); what they did is read then: each
step's loss, the first gradient as the optimizer took it (its first
moment over 1 - beta1 after one step) and each leaf's change after the
last of them. The same state is handed to the window, which runs whole
steps until ``--seconds`` have passed. Once the window has closed and
the state is freed, the reference runs the same steps from the same
weights and batches, and the two are compared:

* ``loss``: the largest relative gap of a step's loss;
* ``grad``: by the worst leaf, the gap between the norms of the first
  clipped gradient, over the larger of the reference's norm of that leaf
  and of the median leaf;
* ``change``: the same for each leaf's change over the checked steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone, as a key's bias under
  the softmax does);
* ``grad_diff``: by the median leaf, the norm of the difference of the
  two first clipped gradients over the larger of the reference's norm of
  that leaf and of the median leaf. The gaps of norms above stay small
  under a lower precision whose rounding is unbiased, and the worst leaf
  of a difference is a few sensitive leaves (early layers' query and key
  projections; an embedding summed in bf16) whatever the precision; the
  median leaf's difference is steady from seed to seed and grows with
  the precision lost. The program's first gradient is kept on the host
  until the reference's is worked out.
"""
from __future__ import annotations

import gc
import statistics
from typing import Dict

import torch

from portbench.harness import core, portcfg, trace as tr, weights
from portbench.harness.traffic import TrainFeed
from portbench.reference import train as ref_train
from portbench.reference.model import fp32_exact

#: A leaf is left out of ``change`` when its reference gradient norm is
#: under this share of the median leaf's.
NOISE_LEAF = 1e-3


def changes(seed: int, shapes, params: Dict[str, torch.Tensor],
            device) -> Dict[str, float]:
    """Each leaf's distance from the seeded start, a group drawn at a time."""
    out = {}
    for g in weights.groups(shapes):
        start = weights.draw_group(seed, g, shapes, device)
        for k, v in start.items():
            out[k] = core.norm(params[k], v)
        del start
    return out


def gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> dict:
    """|prog - ref| / max(ref, median ref) of each kept leaf."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keep}


def worst(by_leaf: dict, n: int = 3) -> list:
    return sorted(by_leaf.items(), key=lambda kv: -kv[1])[:n]


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers the cell's limits hold, from what each side read (and
    on standard error the leaves that read worst)."""
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moving = [k for k in g if g[k] >= NOISE_LEAF * med]
    grad = gaps(prog["grad_norms"], g, list(g))
    change = gaps(prog["changes"], ref["changes"], moving)
    diff = {k: v / max(g[k], med, 1e-30) for k, v in ref["diffs"].items()}
    core.note(losses=prog["losses"], reference_losses=ref["losses"],
              worst_grad=worst(grad), worst_change=worst(change),
              worst_grad_diff=worst(diff),
              left_out=sorted(set(g) - set(moving)))
    return {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                         ref["losses"])),
        "grad": max(grad.values()),
        "change": max(change.values()),
        "grad_diff": statistics.median(diff.values()),
    }


def to_host(tree: Dict[str, torch.Tensor], scale: float = 1.0) -> dict:
    """fp32 host copies of the leaves (times ``scale``), a leaf at a time."""
    return {k: (v.float() * scale).cpu() for k, v in tree.items()}


def reference_side(ctx, shapes, feed, prec: str, against=None) -> dict:
    """The reference's steps from the seeded weights: its losses, first
    clipped gradient norms and changes; with ``against`` (host copies of
    the other side's first clipped gradients), the norm of each leaf's
    difference from them (``diffs``), else its own host copies
    (``first``)."""
    fp32_exact()
    mix = ctx.cell.mix
    P = weights.draw(ctx.seed, shapes, ctx.device)
    kept = {}

    def first(G):
        if against is None:
            kept["first"] = to_host(G)
        else:
            kept["diffs"] = {k: core.norm(g, against[k].to(g.device))
                             for k, g in G.items()}
    out = ref_train.run(ctx.arch, P, feed.microbatches, mix["optimizer"],
                        mix["check_steps"], prec, first)
    out.update(kept)
    out["changes"] = changes(ctx.seed, shapes, P, ctx.device)
    del P
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _traced_optimizer():
    """The program's optimizer update inside an ``optim.apply`` span."""
    import repro_torch.optim as optim
    real = optim.apply

    def apply(*a, **k):
        with torch.profiler.record_function("optim.apply"):
            return real(*a, **k)
    optim.apply = apply
    return lambda: setattr(optim, "apply", real)


def run(ctx) -> dict:
    from repro_torch import optim
    from repro_torch import train as rt
    from repro_torch.tree import flatten

    mix, cfg, dev = ctx.cell.mix, ctx.port_cfg, ctx.device
    cuda = dev.type == "cuda"
    shapes = portcfg.leaf_shapes(cfg)
    feed = TrainFeed(mix, ctx.arch["vocab"], ctx.seed, dev)
    n_check = mix["check_steps"]
    if ctx.control:
        # The reference at the lower precision, in the program's place.
        prog = reference_side(ctx, shapes, feed, "fp8")
        ref = reference_side(ctx, shapes, feed, "fp32", prog.pop("first"))
        return {"numbers": compare(prog, ref), "run": None}

    o = mix["optimizer"]
    tcfg = rt.TrainConfig(
        optimizer=optim.AdamWConfig(
            lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
            weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
            schedule=o["schedule"], warmup_steps=o["warmup_steps"]),
        microbatches=mix["microbatches"])
    state = rt.init_state(portcfg.tree(cfg, weights.draw(ctx.seed, shapes, dev)),
                          tcfg)
    step = rt.make_train_step(cfg, tcfg)

    # Set-up: the checked steps, through the window's step and feed.
    losses, grad_norms, first = [], None, None
    for i in range(n_check):
        state, m = step(state, feed.batch(i))
        losses.append(float(m["loss"]))
        if i == 0:
            moment = flatten(state.opt.m)
            grad_norms = {k: core.norm(v) / (1 - o["b1"])
                          for k, v in moment.items()}
            first = to_host(moment, 1 / (1 - o["b1"]))
            del moment
    prog = {"losses": losses, "grad_norms": grad_norms,
            "changes": changes(ctx.seed, shapes, flatten(state.params), dev)}

    # The window: whole steps until the seconds have passed.
    if cuda:
        torch.cuda.synchronize()
    t0 = core.now()
    setup_s = t0 - ctx.t_start
    steps, failed, captured, ends = 0, 0, None, []
    restore = _traced_optimizer() if ctx.trace else None
    try:
        while True:
            if ctx.trace and captured is None:
                captured = tr.Capture(torch)
                captured.__enter__()
                t_trace = core.now()
            if ctx.trace:
                with torch.profiler.record_function("train.step"):
                    state, m = step(state, feed.batch(n_check + steps))
            else:
                state, m = step(state, feed.batch(n_check + steps))
            loss = float(m["loss"])
            failed += not torch.isfinite(torch.tensor(loss))
            steps += 1
            t = core.now()
            ends.append(t)
            if captured is not None and not captured.done \
                    and t - t_trace >= ctx.trace_seconds:
                captured.__exit__(None, None, None)
            if t - t0 >= ctx.seconds:
                break
        if captured is not None and not captured.done:
            captured.__exit__(None, None, None)
    finally:
        if restore is not None:
            restore()
    window = t - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    core.note(setup_s=setup_s, window_s=window, steps=steps,
              step_s=[b - a for a, b in zip([t0] + ends, ends)],
              peak_bytes=peak)
    del state, step, m
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = core.now()
    ref = reference_side(ctx, shapes, feed, "fp32", first)
    del first
    core.note(reference_s=core.now() - t_ref)
    numbers = compare(prog, ref)
    run = core.Run("train", ctx.arch, mix, window,
                   {"tokens": steps * feed.tokens_per_step, "steps": steps},
                   None if captured is None else captured.read())
    return {"numbers": numbers, "run": run, "attempted": steps,
            "failed": int(failed), "setup_s": setup_s, "peak": peak}
