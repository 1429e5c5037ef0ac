"""Layer-stack assembly: heterogeneous block *periods*, run as a Python loop.

A model is ``first_k_dense`` prefix layers plus N identical *periods*; each
period is the config's ``block_pattern`` (Jamba: 7 mamba + 1 attention with
alternating MoE). The reference stacks each pattern slot's parameters over
periods and scans; the port keeps one parameter dict per (slot, period)
(``params["slots"][j][i]``) and loops. Under autograd each period runs
under ``torch.utils.checkpoint`` as the reference's ``jax.checkpoint``
does, by ``cfg.remat_policy``: ``"full"`` saves nothing and recomputes the
period in the backward, ``"minimal"`` saves the projection matmuls'
outputs (``aten.mm``/``aten.addmm``, the counterpart of
``dots_with_no_batch_dims_saveable``) and recomputes the rest, ``"none"``
saves everything. Without grad (serving) nothing is wrapped.

An encoder-decoder model has a second stack, the encoder: ``encoder_layers``
periods of one non-causal (attention, dense) block. Each decoder block then
also attends over the encoder's memory (cross-attention, no mask): in the
full pass through the flash op, non-causal; in decode over the ``CrossCache``
of K/V that ``init_decode_caches`` projects once from the memory, in plain
PyTorch as the reference does. Under the sharded train step the full
pass's cross-attention splits its heads over ``model`` as self-attention
does (``attention._tensor_parallel``).

Decode caches keep the reference's layout: one cache per prefix layer, one
per pattern slot stacked over periods (a ``KVCacheView`` for attention, a
``MambaCache`` for mamba, so one period may hold both), and for an
encoder-decoder ``cross_prefix`` / ``cross_slots`` of ``CrossCache``.
``stack_decode`` updates them in place through per-period views.
"""
from __future__ import annotations

import functools
from contextlib import nullcontext
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import shardlib
from repro_torch.kernels import ops
from repro_torch.obs.trace import region
from repro_torch.tree import leaves
from .attention import (
    _tensor_parallel,
    attention,
    decode_attention,
    init_attention,
    init_cache,
    output_projection,
)
from .layers import init_mlp, init_rms_norm, mlp, rms_norm
from .mamba import init_mamba, init_mamba_cache, mamba_decode, mamba_layer
from .moe import init_moe, moe_ffn


class CrossCache(NamedTuple):
    k: torch.Tensor   # (B, S_enc, KV, D)
    v: torch.Tensor


def _is_attn(mixer: str) -> bool:
    return mixer in ("attn", "local")


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, mixer: str, ffn: str, device,
               cross_attn: bool = False):
    p: dict = {"norm1": init_rms_norm(cfg.d_model, cfg.pdtype, device),
               "norm2": init_rms_norm(cfg.d_model, cfg.pdtype, device)}
    if _is_attn(mixer):
        p["mixer"] = init_attention(gen, cfg, device)
    else:
        p["mixer"] = init_mamba(gen, cfg, device)
    if ffn == "moe":
        p["ffn"] = init_moe(gen, cfg, device)
    elif ffn == "dense":
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, device,
                            gated=cfg.mlp_gated)
    # ffn == "none" (pure Mamba-2): no FFN params, norm2 unused.
    if cross_attn:
        p["cross"] = init_attention(gen, cfg, device)
        p["norm_c"] = init_rms_norm(cfg.d_model, cfg.pdtype, device)
    return p


def block_forward(p, x, positions, cfg: ModelConfig, mixer: str, ffn: str,
                  *, causal: bool = True, memory: Optional[torch.Tensor] = None,
                  return_cache: bool = False):
    """Pre-norm block. Returns (x, aux_loss, cache|None)."""
    h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    cache = None
    if _is_attn(mixer):
        out = attention(p["mixer"], h, positions, cfg, kind=mixer,
                        causal=causal, return_cache=return_cache)
    else:
        out = mamba_layer(p["mixer"], h, cfg, return_cache=return_cache)
    if return_cache:
        out, cache = out
    x = x + out

    if memory is not None and "cross" in p:
        hc = rms_norm(x, p["norm_c"]["scale"], cfg.norm_eps)
        x = x + _cross_attention(p["cross"], hc, memory, cfg)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "none":
        return x, aux, cache
    h2 = rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
    if ffn == "moe":
        y, aux, _ = moe_ffn(p["ffn"], h2, cfg, cfg.act_fn)
    else:
        y = mlp(p["ffn"], h2, cfg.act_fn, cfg.cdtype, d_ff=cfg.d_ff)
    return x + y, aux, cache


def _proj(x, w):
    """"bsd,dhe->bshe": x (B, S, d) through w (d, heads, e)."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).view(b, s, *w.shape[1:])


def _cross_attention(p, x, memory, cfg: ModelConfig,
                     kv: Optional[CrossCache] = None):
    """q from the decoder, K/V from the encoder memory (or ``kv``), no mask.
    The full pass runs the flash op, non-causal; decode (``kv`` given)
    attends in plain PyTorch, as the reference's jnp does.

    The full pass is tensor-parallel where ``wq`` and ``wo`` are this
    rank's block of heads on ``model``, as self-attention is: ``x``, the
    ``memory`` and the replicated ``wk``/``wv`` enter through ``copy_to``
    (so the encoder's gradient sums every rank's heads), K and V cover the
    KV heads the rank's heads read, and ``wo`` goes by rows."""
    dt = cfg.cdtype
    tp = None if kv is not None else _tensor_parallel(p, cfg)
    if tp is not None:
        mesh, first, count, local = tp
        x = shardlib.copy_to(x, "model", mesh)
        memory = shardlib.copy_to(memory, "model", mesh)
        heads = slice(first, first + count)
        wk = shardlib.copy_to(p["wk"], "model", mesh)[:, heads]
        wv = shardlib.copy_to(p["wv"], "model", mesh)[:, heads]
    else:
        wk, wv = p["wk"], p["wv"]
    q = _proj(x, p["wq"].to(dt))
    b, s, h, d = q.shape
    if kv is None:
        k = _proj(memory, wk.to(dt))
        v = _proj(memory, wv.to(dt))
        if tp is not None and local is not None:
            # Heads that flash's grouping would pair wrongly: one KV each.
            idx = torch.tensor(local, device=k.device)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        out = ops.flash_attention_op(q, k, v.contiguous(), causal=False)
        return output_projection(out, p["wo"], cfg)
    kvh = cfg.num_kv_heads
    g = cfg.num_heads // kvh
    scores = torch.einsum("bqkgd,bskd->bkgqs",
                          q.reshape(b, s, kvh, g, d).float(),
                          kv.k.float()) * d ** -0.5
    pr = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", pr.to(dt), kv.v.to(dt))
    return output_projection(out.permute(0, 3, 1, 2, 4), p["wo"], cfg)


def cross_kv(p, memory, cfg: ModelConfig) -> CrossCache:
    dt = cfg.cdtype
    return CrossCache(k=_proj(memory, p["wk"].to(dt)),
                      v=_proj(memory, p["wv"].to(dt)))


# ---------------------------------------------------------------------------
# Stack: prefix layers + periods
# ---------------------------------------------------------------------------

def _pattern(cfg: ModelConfig, encoder: bool = False):
    if encoder:
        return (("attn", "dense"),)
    return cfg.block_pattern


def n_periods(cfg: ModelConfig, encoder: bool = False) -> int:
    if encoder:
        return cfg.encoder_layers
    n = cfg.num_layers - cfg.first_k_dense
    if n % len(cfg.block_pattern):
        raise ValueError(f"{cfg.name}: {n} layers after the dense prefix "
                         f"do not divide into periods of "
                         f"{len(cfg.block_pattern)}")
    return n // len(cfg.block_pattern)


def init_stack(gen, cfg: ModelConfig, device, *, encoder: bool = False,
               cross_attn: bool = False):
    """{"prefix": [block, ...], "slots": ([block per period], ...)}: one
    parameter dict per layer, in the reference's layer order."""
    pattern = _pattern(cfg, encoder)
    periods = n_periods(cfg, encoder)
    prefix = [] if encoder else [
        init_block(gen, cfg, pattern[0][0], "dense", device, cross_attn)
        for _ in range(cfg.first_k_dense)]
    slots = tuple([] for _ in pattern)
    for _ in range(periods):
        for j, (mixer, ffn) in enumerate(pattern):
            slots[j].append(init_block(gen, cfg, mixer, ffn, device,
                                       cross_attn))
    return {"prefix": prefix, "slots": slots}


def _stack_caches(caches):
    """Per-period caches of one slot (all of one type), stacked on a
    leading period axis as the reference's scan returns them."""
    return type(caches[0])(*(torch.stack(parts) for parts in zip(*caches)))


def _save_projections(ctx, op, *args, **kwargs):
    """The ``"minimal"`` policy: keep the outputs of the 2-D matmuls (the
    projections), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _needs_grad(x, period_params) -> bool:
    if not torch.is_grad_enabled():
        return False
    return x.requires_grad or any(p.requires_grad
                                  for p in leaves(period_params))


def _remat(fn, cfg: ModelConfig):
    """``fn`` under the config's remat policy (the caller applies it only
    under autograd)."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy not in ("full", "minimal"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    kwargs = {}
    if cfg.remat_policy == "minimal":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_projections)
    mesh, rules = shardlib.current_mesh(), dict(shardlib.current_rules())

    def under_mesh(*args):
        # The recompute runs on autograd's thread for the card, which has
        # no thread mesh of its own: it takes the forward's (expert
        # parallelism and its collectives read it). Inside a backward
        # (a graph task is running) this call is the recompute.
        recompute = (torch.autograd._profiler_enabled()
                     and torch._C._current_graph_task_id() != -1)
        with shardlib.use_mesh(mesh, rules), \
                region("model.recompute") if recompute else nullcontext():
            return fn(*args)
    return functools.partial(checkpoint, under_mesh, use_reentrant=False,
                             preserve_rng_state=False, **kwargs)


def stack_forward(params, x, positions, cfg: ModelConfig, *,
                  encoder: bool = False, memory: Optional[torch.Tensor] = None,
                  return_caches: bool = False):
    """Full-sequence pass. Returns (x, aux_loss, caches).

    caches: {"prefix": [...], "slots": tuple per slot, stacked over periods}
    """
    pattern = _pattern(cfg, encoder)
    causal = not encoder
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    prefix_caches = []
    for p in params["prefix"]:
        x, aux, c = block_forward(p, x, positions, cfg, pattern[0][0], "dense",
                                  causal=causal, memory=memory,
                                  return_cache=return_caches)
        aux_total = aux_total + aux
        prefix_caches.append(c)

    def period(x, aux_acc, blocks):
        caches = []
        for p, (mixer, ffn) in zip(blocks, pattern):
            x, aux, c = block_forward(p, x, positions, cfg, mixer, ffn,
                                      causal=causal, memory=memory,
                                      return_cache=return_caches)
            aux_acc = aux_acc + aux
            caches.append(c)
        return x, aux_acc, caches

    slot_caches = tuple([] for _ in pattern)
    for i in range(len(params["slots"][0])):
        blocks = [slot[i] for slot in params["slots"]]
        run = _remat(period, cfg) if _needs_grad(x, blocks) else period
        x, aux_total, caches = run(x, aux_total, blocks)
        for j, c in enumerate(caches):
            slot_caches[j].append(c)
    caches: Optional[dict] = None
    if return_caches:
        caches = {"prefix": prefix_caches,
                  "slots": tuple(_stack_caches(c) for c in slot_caches)}
    return x, aux_total, caches


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------

def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device=None, memory: Optional[torch.Tensor] = None,
                       params=None):
    """Empty caches for the decoder stack: ``{"prefix": [cache, ...],
    "slots": (cache stacked over periods, ...)}``, a ``KVCacheView`` for
    each attention layer and a ``MambaCache`` for each mamba layer. With the
    encoder ``memory`` and the decoder stack's ``params``, also the
    cross-attention K/V: ``cross_prefix`` and ``cross_slots``."""
    pattern = _pattern(cfg)
    periods = n_periods(cfg)

    def one(mixer):
        if _is_attn(mixer):
            return init_cache(cfg, batch, max_len, mixer, device)
        return init_mamba_cache(cfg, batch, device)

    def stacked(c):
        return type(c)(*(x.unsqueeze(0).repeat((periods,) + (1,) * x.ndim)
                         for x in c))

    caches = {"prefix": [one(pattern[0][0])
                         for _ in range(cfg.first_k_dense)],
              "slots": tuple(stacked(one(m)) for m, _ in pattern)}
    if memory is not None and params is not None:
        caches["cross_prefix"] = [cross_kv(p["cross"], memory, cfg)
                                  for p in params["prefix"]]
        caches["cross_slots"] = tuple(
            _stack_caches([cross_kv(sp["cross"], memory, cfg) for sp in slot])
            for slot in params["slots"])
    return caches


def _period_view(cache, i: int):
    """Period i of a stacked cache (any of the cache types): views, so
    writes land in the stack."""
    return type(cache)(*(x[i] for x in cache))


def stack_decode(params, x, caches, cur_pos, cfg: ModelConfig):
    """One-token decode through the stack. x: (B, 1, d).

    Returns ``(x, caches)``; the caches are updated in place and returned
    as the same objects. Cross-attention runs where the caches hold its
    K/V, as in the reference.
    """
    pattern = _pattern(cfg)

    def block_step(p, x, cache, mixer, ffn, cross=None):
        h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
        if _is_attn(mixer):
            out, _ = decode_attention(p["mixer"], h, cache, cur_pos, cfg,
                                      kind=mixer)
        else:
            out, _ = mamba_decode(p["mixer"], h, cache, cfg)
        x = x + out
        if cross is not None:
            hc = rms_norm(x, p["norm_c"]["scale"], cfg.norm_eps)
            x = x + _cross_attention(p["cross"], hc, None, cfg, kv=cross)
        if ffn == "none":
            return x
        h2 = rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
        if ffn == "moe":
            y, _, _ = moe_ffn(p["ffn"], h2, cfg, cfg.act_fn)
        else:
            y = mlp(p["ffn"], h2, cfg.act_fn, cfg.cdtype)
        return x + y

    cross_prefix = caches.get("cross_prefix")
    for i, (p, cache) in enumerate(zip(params["prefix"], caches["prefix"])):
        x = block_step(p, x, cache, pattern[0][0], "dense",
                       None if cross_prefix is None else cross_prefix[i])
    cross_slots = caches.get("cross_slots")
    for i in range(len(params["slots"][0])):
        for j, (mixer, ffn) in enumerate(pattern):
            cross = None if cross_slots is None else \
                _period_view(cross_slots[j], i)
            x = block_step(params["slots"][j][i], x,
                           _period_view(caches["slots"][j], i), mixer, ffn,
                           cross)
    return x, caches
