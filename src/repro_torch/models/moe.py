"""Mixture-of-experts with sort-based capacity dispatch.

The dispatch plan (which token row goes to which expert slot) is a
descriptor stream in the paper's sense: src = token index, dst = (expert,
slot). :func:`moe_dispatch_plan` emits it; :func:`moe_ffn` executes it with
the hand-written gather and combine kernels
(:func:`repro_torch.kernels.ops.moe_gather_op` and ``moe_combine_op``), and
the expert products stay plain batched matrix products, as the reference
leaves them outside any kernel. Under autograd each op also takes the
plan's other stream, which its backward kernel reads (the gather's
backward gathers through ``inv_slot``; the combine's zeroes the slots
``token_idx`` leaves empty). A recompute under remat rebuilds the same
plan: the router's logits come from the saved projection (remat
"minimal") or the same deterministic product, and the top-k and the sorts
are stable.

Routing: softmax router, top-k (optionally renormalised), capacity-bounded
with token dropping (GShard-style), shared experts added densely
(DeepSeek-V2), plus load-balance and router-z auxiliary losses. Top-k ties
go to the lower expert index, as the reference's top-k orders them: the
top-k is a stable sort of the negated probabilities (``torch.topk``
promises no order among ties).

The expert-parallel form of the reference (``_moe_ffn_ep``, shard_map) is
not ported: one GPU runs :func:`moe_ffn` as the reference's GSPMD form.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels import ops
from .layers import activation, dense_init, init_mlp, mlp


class DispatchPlan(NamedTuple):
    """Descriptor streams for token<->expert movement (static shapes).

    Forward stream (dispatch): slot s <- token_idx[s]  (length E*C).
    Inverse stream (combine):  token t <- sum_j inv_weight[t,j] *
                               expert_out[inv_slot[t,j]]  (shape T x k).
    """
    token_idx: torch.Tensor    # (E*C,) int32 source token row, -1 = empty
    weight: torch.Tensor       # (E*C,) fp32 combine weight for the slot
    inv_slot: torch.Tensor     # (T, k) int32 expert slot per copy, -1 dropped
    inv_weight: torch.Tensor   # (T, k) fp32 combine weight (0 where dropped)
    num_dropped: torch.Tensor  # () int tokens dropped by capacity


def init_moe(gen, cfg: ModelConfig, device):
    m = cfg.moe
    d = cfg.d_model
    p = {
        "router": dense_init(gen, (d, m.num_experts), torch.float32, device),
        "w_gate": dense_init(gen, (m.num_experts, d, m.expert_d_ff),
                             cfg.pdtype, device),
        "w_up": dense_init(gen, (m.num_experts, d, m.expert_d_ff),
                           cfg.pdtype, device),
        "w_down": dense_init(gen, (m.num_experts, m.expert_d_ff, d),
                             cfg.pdtype, device),
    }
    if m.num_shared_experts:
        p["shared"] = init_mlp(
            gen, d, (m.shared_d_ff or m.expert_d_ff) * m.num_shared_experts,
            cfg.pdtype, device)
    return p


def capacity(num_tokens: int, m: MoEConfig) -> int:
    c = int(num_tokens * m.experts_per_token * m.capacity_factor
            // m.num_experts)
    return max(8, (c + 7) // 8 * 8)  # pad to 8 for tiling friendliness


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, descending,
    ties to the lower index (the reference's order)."""
    idx = torch.sort(-probs, dim=-1, stable=True).indices[..., :k]
    return probs.gather(-1, idx), idx


def moe_dispatch_plan(router_probs: torch.Tensor, m: MoEConfig,
                      cap: int) -> DispatchPlan:
    """Build the dispatch descriptor stream from router probabilities.

    router_probs: (T, E) fp32. Returns slots for each of E experts x cap.
    """
    t, e = router_probs.shape
    k = m.experts_per_token
    dev = router_probs.device
    topv, topi = top_k(router_probs, k)                     # (T, k)
    if m.router_norm_topk:
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_expert = topi.reshape(-1)                          # (T*k,)
    flat_weight = topv.reshape(-1)
    flat_token = torch.arange(t, dtype=torch.int32,
                              device=dev).repeat_interleave(k)

    # Stable sort by expert id; rank within expert = position - group start.
    order = torch.sort(flat_expert, stable=True).indices
    se, stok, sw = flat_expert[order], flat_token[order], flat_weight[order]
    group_start = torch.searchsorted(se, torch.arange(e, device=dev))
    rank = torch.arange(t * k, device=dev) - group_start[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)      # drop -> overflow

    # The overflow slot e * cap takes every dropped copy and is cut away.
    token_idx = torch.full((e * cap + 1,), -1, dtype=torch.int32, device=dev)
    token_idx[slot] = stok
    weight = torch.zeros((e * cap + 1,), dtype=torch.float32, device=dev)
    weight[slot] = sw

    # Inverse plan: scatter each sorted entry's slot back to its (t, j) copy.
    inv_flat = torch.full((t * k,), -1, dtype=torch.int32, device=dev)
    inv_flat[order] = torch.where(keep, slot, -1).to(torch.int32)
    inv_slot = inv_flat.reshape(t, k)
    inv_weight = torch.where(inv_slot >= 0, topv, 0.0)
    return DispatchPlan(token_idx[:-1], weight[:-1], inv_slot, inv_weight,
                        (~keep).sum())


def aux_losses(router_probs: torch.Tensor, topi: torch.Tensor, m: MoEConfig,
               router_logits: torch.Tensor):
    """Switch/GShard load-balance loss + router z-loss."""
    t, e = router_probs.shape
    me = router_probs.mean(dim=0)                                # (E,)
    onehot = F.one_hot(topi, e).float().sum(1)                   # (T, E)
    ce = onehot.mean(dim=0) * e / m.experts_per_token
    lb = (me * ce).sum() * e * m.aux_loss_weight
    z = torch.logsumexp(router_logits, dim=-1).square().mean()
    return lb + m.router_z_weight * z, {"moe_lb": lb, "moe_z": z}


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig,
            act_fn: str = "silu") -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """x: (B, S, d) -> (y, aux_loss, metrics): the reference's GSPMD form
    on one device, with the gather and the combine as kernels."""
    m = cfg.moe
    dt = cfg.cdtype
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)

    logits = xt.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    cap = capacity(t, m)
    plan = moe_dispatch_plan(probs, m, cap)
    _, topi = top_k(probs, m.experts_per_token)
    aux, metrics = aux_losses(probs, topi, m, logits)

    # Gather tokens into (E, C, d): the descriptor-engine gather.
    xe = ops.moe_gather_op(plan.token_idx, xt.contiguous(),
                           inv_slot=plan.inv_slot)
    xe = xe.to(dt).view(m.num_experts, cap, d)

    act = activation(act_fn)
    gate = torch.bmm(xe, params["w_gate"].to(dt))
    up = torch.bmm(xe, params["w_up"].to(dt))
    h = act(gate) * up
    del gate, up
    ye = torch.bmm(h, params["w_down"].to(dt))

    # Combine via the inverse descriptor stream, fp32 accumulation.
    y = ops.moe_combine_op(plan.inv_slot, plan.inv_weight,
                           ye.view(m.num_experts * cap, d),
                           token_idx=plan.token_idx)
    y = y.to(dt)
    if m.num_shared_experts:
        y = y + mlp(params["shared"], xt, act_fn, dt)

    metrics = dict(metrics, moe_dropped=plan.num_dropped / max(t, 1))
    return y.view(b, s, d), aux, metrics
