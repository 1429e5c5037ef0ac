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

Under a mesh backed by process groups with a ``model`` axis that divides
the experts, :func:`moe_ffn` runs expert-parallel, as the reference's
``_moe_ffn_ep`` does inside ``shard_map``: each rank dispatches its own
tokens to every expert (per-shard capacity), gathers and runs only its
experts' slots, combines only those, and the partial token outputs are
summed over ``model`` (:func:`repro_torch.distributed.shardlib.reduce_from`).
Any other mesh (the dry run's ``meta`` meshes, the logical shards) runs
the one-device form. The shared experts are one dense MLP of their summed
width, tensor-parallel over it where the sharded step hands over their
block on ``model`` (``layers.mlp``): an all-reduce of its own beside the
experts' sum.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed import shardlib
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
        p["shared"] = init_mlp(gen, d, _shared_d_ff(m), cfg.pdtype, device)
    return p


def _shared_d_ff(m: MoEConfig) -> int:
    """The shared experts' width, as one dense MLP."""
    return (m.shared_d_ff or m.expert_d_ff) * m.num_shared_experts


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


def _experts(h: torch.Tensor, params, act_fn: str, dt) -> torch.Tensor:
    """(E, C, d) slot rows through their experts' gated MLPs."""
    act = activation(act_fn)
    gate = torch.bmm(h, params["w_gate"].to(dt))
    up = torch.bmm(h, params["w_up"].to(dt))
    h = act(gate) * up
    del gate, up
    return torch.bmm(h, params["w_down"].to(dt))


def _batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the rules split the batch over: each rank's tokens
    are its own along them."""
    return mesh.axes(shardlib.current_rules().get("batch"))


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig,
            act_fn: str = "silu") -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """x: (B, S, d) -> (y, aux_loss, metrics).

    Expert-parallel (:func:`_moe_ffn_ep`) under a process mesh whose
    ``model`` axis divides the experts, as the reference picks its
    ``shard_map`` form; otherwise the reference's GSPMD form on one
    device, with the gather and the combine as kernels."""
    mesh = shardlib.process_mesh()
    if (mesh is not None and "model" in mesh.shape
            and cfg.moe.num_experts % mesh.shape["model"] == 0):
        return _moe_ffn_ep(params, x, cfg, act_fn, mesh)
    y, aux, metrics = _moe_ffn_one(params, x, cfg, act_fn)
    if mesh is not None:
        # The step sums gradients over the batch axes: a replicated mean.
        batch = _batch_axes(mesh)
        aux = shardlib.pmean(aux, batch, mesh)
        metrics = dict(metrics, moe_dropped=shardlib.pmean(
            metrics["moe_dropped"], batch, mesh))
    return y, aux, metrics


def _moe_ffn_ep(params, x: torch.Tensor, cfg: ModelConfig, act_fn: str,
                mesh) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Expert-parallel MoE on a process mesh: rank ``r`` of ``model``
    builds the plan over its own tokens, gathers only its slots ``[r *
    E_loc * cap, (r + 1) * E_loc * cap)`` (``moe_gather``), runs its
    ``E_loc`` experts, combines only its own slots (``moe_combine``) and
    the partial outputs sum over ``model``. Dispatch moves no token across
    ranks. The expert leaves are the rank's ``E_loc`` experts (the sharded
    step's blocks), or all ``E``, of which the rank takes its own.

    Gradients: the sum's backward is the identity (every rank's consumer
    is the same), and the tokens and router probabilities entering the
    rank's slots go through :func:`shardlib.copy_to`, whose backward sums
    the rank's partial gradients over ``model``; the auxiliary loss reads
    the probabilities themselves, whole on every rank. Both kernels'
    backwards take the other stream of the rank's *local* sub-plan, which
    keeps the plan's duality. The aux loss and the drop share are means
    over the batch axes (the reference's ``pmean``); the batch there is
    the step's rows, split over every batch axis."""
    m = cfg.moe
    dt = cfg.cdtype
    b, s, d = x.shape
    t = b * s
    n_model = mesh.shape["model"]
    e_loc = m.num_experts // n_model
    xt = x.reshape(t, d)

    logits = xt.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    cap = capacity(t, m)
    plan = moe_dispatch_plan(shardlib.copy_to(probs, "model", mesh), m, cap)
    _, topi = top_k(probs, m.experts_per_token)
    aux, _ = aux_losses(probs, topi, m, logits)

    # The rank's sub-plan: its slots, and the copies that point at them.
    n_slots = e_loc * cap
    slot0 = mesh.coords["model"] * n_slots
    own_tokens = plan.token_idx[slot0:slot0 + n_slots].contiguous()
    rel = plan.inv_slot - slot0
    own = (rel >= 0) & (rel < n_slots)
    local_inv = torch.where(own, rel, -1).to(torch.int32)
    local_w = torch.where(own, plan.inv_weight, 0.0)

    xe = ops.moe_gather_op(own_tokens,
                           shardlib.copy_to(xt, "model", mesh).contiguous(),
                           inv_slot=local_inv)
    experts = params
    if params["w_gate"].shape[0] == m.num_experts and e_loc != m.num_experts:
        lo = mesh.coords["model"] * e_loc
        experts = {k: params[k][lo:lo + e_loc]
                   for k in ("w_gate", "w_up", "w_down")}
    ye = _experts(xe.to(dt).view(e_loc, cap, d), experts, act_fn, dt)
    y = ops.moe_combine_op(local_inv, local_w, ye.view(n_slots, d),
                           token_idx=own_tokens).to(dt)
    y = shardlib.reduce_from(y, "model", mesh)

    batch = _batch_axes(mesh)
    aux = shardlib.pmean(aux, batch, mesh)
    dropped = shardlib.pmean(plan.num_dropped / max(t, 1), batch, mesh)
    if m.num_shared_experts:
        y = y + mlp(params["shared"], xt, act_fn, dt, d_ff=_shared_d_ff(m))
    return y.view(b, s, d), aux, {"moe_dropped": dropped}


def _moe_ffn_one(params, x: torch.Tensor, cfg: ModelConfig,
                 act_fn: str) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """The reference's GSPMD form on one device."""
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
    ye = _experts(xe.to(dt).view(m.num_experts, cap, d), params, act_fn, dt)

    # Combine via the inverse descriptor stream, fp32 accumulation.
    y = ops.moe_combine_op(plan.inv_slot, plan.inv_weight,
                           ye.view(m.num_experts * cap, d),
                           token_idx=plan.token_idx)
    y = y.to(dt)
    if m.num_shared_experts:
        y = y + mlp(params["shared"], xt, act_fn, dt, d_ff=_shared_d_ff(m))

    metrics = dict(metrics, moe_dropped=plan.num_dropped / max(t, 1))
    return y.view(b, s, d), aux, metrics
