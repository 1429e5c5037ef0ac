"""The reference's training steps: the loss and every weight's gradient
(the mean over the step's microbatches), clipped by their global norm,
then AdamW with decoupled weight decay on every leaf. Moments are fp32;
a parameter kept in bf16 is updated in fp32 and rounded back, as the
configuration keeps it."""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from .arch import reference_model

#: Elements an update takes at once.
CHUNK = 1 << 26


def learning_rate(o: dict, step: int) -> float:
    """The learning rate at ``step``: the mixes' constant rate, with no
    warmup (no other schedule is followed here, so none may be asked)."""
    assert o["schedule"] == "constant" and o["warmup_steps"] == 0, o
    return o["lr"]


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def grads(arch: dict, P: Dict[str, torch.Tensor], batches: List[dict],
          prec: str) -> tuple:
    """(loss, G) of one step: the mean over ``batches`` (its microbatches)
    of each one's loss and gradients, G fp32 by path."""
    G = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
         for k, v in P.items()}
    model = reference_model(arch)(arch, P, G, prec)
    n = len(batches)
    total = 0.0
    for b in batches:
        with torch.enable_grad():
            loss = model.loss(b["tokens"], b["labels"])
            (loss / n).backward()
        total += float(loss.detach()) / n
        model.small_grads()
    return total, G


def adamw(o: dict, P, G, m, v, step: int) -> dict:
    """One AdamW update of ``P`` in place (``step`` counted from 1), its
    gradients first clipped to ``grad_clip`` by their global norm.
    Returns the clipped gradients' norms by leaf."""
    gnorm = math.sqrt(sum(float(torch.dot(g.reshape(-1), g.reshape(-1)))
                          for g in G.values()))
    scale = min(o["grad_clip"] / max(gnorm, 1e-9), 1.0) if o["grad_clip"] \
        else 1.0
    lr = learning_rate(o, step)
    b1, b2 = o["b1"], o["b2"]
    b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
    norms = {}
    for k, p in P.items():
        g = G[k].mul_(scale)
        norms[k] = float(torch.linalg.vector_norm(g.double()))
        flat = [x.view(-1) for x in (p, g, m[k], v[k])]
        # In pieces, so the fp32 temporaries stay small whatever the leaf.
        for i in range(0, p.numel(), CHUNK):
            pp, gg, mm, vv = (x[i:i + CHUNK] for x in flat)
            mm.mul_(b1).add_((1 - b1) * gg)
            vv.mul_(b2).add_((1 - b2) * gg * gg)
            delta = (mm / b1c) / ((vv / b2c).sqrt() + o["eps"]) \
                + o["weight_decay"] * pp.float()
            pp.copy_((pp.float() - lr * delta).to(p.dtype))
    return norms


def run(arch: dict, P: Dict[str, torch.Tensor],
        batches: Callable[[int], List[dict]], o: dict, steps: int,
        prec: str = "fp32", first_grads=None) -> dict:
    """``steps`` training steps from the weights ``P`` (updated in place) on
    ``batches(i)``, the microbatches of step i. Returns each step's loss
    and the first step's clipped gradient norms by leaf; ``first_grads``,
    if given, is called with the first step's clipped gradients."""
    m = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for k, p in P.items()}
    v = {k: torch.zeros_like(x) for k, x in m.items()}
    losses, first = [], None
    for i in range(steps):
        loss, G = grads(arch, P, batches(i), prec)
        losses.append(loss)
        norms = adamw(o, P, G, m, v, i + 1)
        if first is None:
            first = norms
            if first_grads is not None:
                first_grads(G)
        del G
    return {"losses": losses, "grad_norms": first}
