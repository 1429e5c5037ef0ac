"""Attention: GQA/MHA with q/k-norm, partial RoPE, sliding windows, and MLA.

Train/prefill attention runs the core through
:func:`repro_torch.kernels.ops.flash_attention_op`: the hand-written CUDA
flash kernel on the card, its plain version on the CPU. The kernel takes
positions that count from 0 (what ``model.forward`` builds), the config's
logit softcap, and the head dims of ``FLASH_SHAPES`` (the reduced
configs' 16, 24, MLA's 24 over 16 and 32; the published 64, 96, 128,
MLA's 192 over values of 128, and gemma3-12b's 256), which cover every
registered config, published and reduced. Anything else runs
:func:`blockwise_attention` (the flash schedule in plain PyTorch) on the
CPU and raises ``NotImplementedError`` on the card: nothing on the card
gives way quietly to a plain version.

Decode attends one new token per row against a dense-view cache with
per-slot position tags (:class:`KVCacheView`): slot = pos % cache_len, so
full caches, sliding windows and ring buffers share one masking rule. The
reference's decode is jnp over that view, not a Pallas kernel, and so is
the port's. Where the reference rebuilds the cache functionally
(``.at[].set``), the port writes the new token's K/V and tag into the
cache in place: a cache is allocated once and lives as long as its state.

MLA (DeepSeek-V2's multi-head latent attention) prefills in the expanded
form, through the flash kernel at query/key heads of 192 and value heads
of 128, and caches the compressed latent (c_kv | k_rope) per position in
``KVCacheView.k`` as (B, S, 1, kv_lora + rope) beside a (B, S, 1, 0) ``v``.
Its decode attends in the latent space (kv_up absorbed into the query), in
plain PyTorch as the reference's jnp is, writing latent and tag in place.

Under the sharded train step GQA attention may run tensor-parallel, as the
reference's rules split ``heads`` over ``model``: ``wq`` (and ``bq``) then
hold this rank's heads, ``wo`` their rows, and the output's parts sum over
``model`` (``shardlib.reduce_from``); K and V cover only the KV heads the
rank's heads read. MLA splits the same way: ``q_up`` and ``kv_up`` hold
the rank's heads and ``wo`` their rows, and the latents every head reads
enter them through ``copy_to``. Its absorbed decode (serving) keeps whole
heads.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import shardlib
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import FLASH_SHAPES
from .layers import apply_rope, dense_init, init_rms_norm, rms_norm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, device):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    dt = cfg.pdtype
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "q_down": dense_init(gen, (d, m.q_lora_rank), dt, device),
            "q_norm": init_rms_norm(m.q_lora_rank, dt, device),
            "q_up": dense_init(gen, (m.q_lora_rank, h, qk), dt, device),
            "kv_down": dense_init(gen, (d, m.kv_lora_rank
                                        + m.qk_rope_head_dim), dt, device),
            "kv_norm": init_rms_norm(m.kv_lora_rank, dt, device),
            "kv_up": dense_init(gen, (m.kv_lora_rank, h, m.qk_nope_head_dim
                                      + m.v_head_dim), dt, device),
            "wo": dense_init(gen, (h, m.v_head_dim, d), dt, device,
                             in_axis=0),
        }
    p = {
        "wq": dense_init(gen, (d, h, hd), dt, device),
        "wk": dense_init(gen, (d, kv, hd), dt, device),
        "wv": dense_init(gen, (d, kv, hd), dt, device),
        "wo": dense_init(gen, (h, hd, d), dt, device, in_axis=0),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, dt, device)
        p["k_norm"] = init_rms_norm(hd, dt, device)
    return p


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention — the plain schedule
# ---------------------------------------------------------------------------

def _mask(q_pos, kv_pos, causal: bool, window: Optional[int]):
    """q_pos: (..., Sq), kv_pos: (..., Sk) -> (..., Sq, Sk) additive mask."""
    ok = kv_pos[..., None, :] >= 0
    if causal:
        ok = ok & (kv_pos[..., None, :] <= q_pos[..., :, None])
    if window is not None:
        ok = ok & (q_pos[..., :, None] - kv_pos[..., None, :] < window)
    return torch.where(ok, 0.0, NEG_INF)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        q_positions: Optional[torch.Tensor] = None,
                        kv_positions: Optional[torch.Tensor] = None,
                        softcap: Optional[float] = None,
                        q_block: int = 512,
                        kv_block: int = 512) -> torch.Tensor:
    """Memory-efficient attention: an outer loop over q blocks, an inner one
    over kv blocks with running (max, sum, acc) — the flash schedule.

    q: (B, Sq, H, D); k: (B, Sk, KV, D); v: (B, Sk, KV, Dv) (Dv may differ).
    """
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    dv = v.shape[-1]
    g = h // kv
    scale = d ** -0.5
    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    if sq % q_block or sk % kv_block:
        raise ValueError(f"blocks ({q_block}, {kv_block}) must divide "
                         f"({sq}, {sk})")
    nq, nk = sq // q_block, sk // kv_block
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(sq, dtype=torch.int32,
                                   device=dev).expand(b, sq)
    if kv_positions is None:
        kv_positions = torch.arange(sk, dtype=torch.int32,
                                    device=dev).expand(b, sk)

    qb = q.reshape(b, nq, q_block, kv, g, d)
    kb = k.reshape(b, nk, kv_block, kv, d)
    vb = v.reshape(b, nk, kv_block, kv, dv)
    qpb = q_positions.reshape(b, nq, q_block)
    kpb = kv_positions.reshape(b, nk, kv_block)

    outs = []
    for qi in range(nq):
        qi_q = qb[:, qi].float()                      # (B, qb, KV, G, D)
        qi_pos = qpb[:, qi]
        m_run = torch.full((b, kv, g, q_block), NEG_INF, device=dev)
        l_run = torch.zeros((b, kv, g, q_block), device=dev)
        acc = torch.zeros((b, kv, g, q_block, dv), device=dev)
        for ki in range(nk):
            kk, vv, kpos = kb[:, ki], vb[:, ki], kpb[:, ki]
            s = torch.einsum("bqkgd,bskd->bkgqs", qi_q, kk.float()) * scale
            if softcap is not None:
                s = torch.tanh(s / softcap) * softcap
            s = s + _mask(qi_pos, kpos, causal, window)[:, None, None]
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vv.dtype).float(), vv.float())
            m_run = m_new
        out = acc / l_run.clamp_min(1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_block, h, dv))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Full-pass (train / prefill) attention layers
# ---------------------------------------------------------------------------

class KVCacheView(NamedTuple):
    """Dense-view cache for one layer: position-tagged slots."""
    k: torch.Tensor          # (B, S, KV, D); MLA: (B, S, 1, lora + rope)
    v: torch.Tensor          # (B, S, KV, D); MLA: a (B, S, 1, 0) placeholder
    kv_pos: torch.Tensor     # (B, S) int32, -1 = empty


def _tensor_parallel(params, cfg: ModelConfig):
    """Under the sharded step's tensor parallelism (``wq`` this rank's block
    of heads on ``model``): ``(mesh, first, count, index)``, the KV heads
    ``[first, first + count)`` the rank's query heads read and, where
    flash's grouping (local head ``j`` reads local KV head ``j // (H_loc /
    count)``) would pair them otherwise, each local head's KV head in that
    range (None when it pairs them right). None for whole heads."""
    h_loc = params["wq"].shape[1]
    tp = shardlib.model_block(h_loc, cfg.num_heads)
    if tp is None:
        return None
    mesh, r = tp
    g = cfg.num_heads // cfg.num_kv_heads
    kv = [(r * h_loc + j) // g for j in range(h_loc)]
    first, count = kv[0], kv[-1] - kv[0] + 1
    local = [k - first for k in kv]
    if h_loc % count == 0 and local == [j // (h_loc // count)
                                        for j in range(h_loc)]:
        return mesh, first, count, None
    return mesh, first, count, local


def _project_qkv(params, x, cfg: ModelConfig, positions):
    """q, k, v (B, S, heads, D), q and k normed and rotated. Under tensor
    parallelism, q over the rank's heads and k, v over the KV heads they
    read (see :func:`_tensor_parallel`); ``x`` and the replicated leaves
    (``wk``, ``wv``, their biases, the q/k norms) enter through
    ``copy_to``, so the gradient of each sums the ranks' parts."""
    dt = cfg.cdtype
    b, s, dm = x.shape
    tp = _tensor_parallel(params, cfg)
    p = params
    if tp is not None:
        mesh, first, count, _ = tp
        x = shardlib.copy_to(x, "model", mesh)
        kv_heads = slice(first, first + count)

        def replicated(k):
            v = shardlib.copy_to(params[k], "model", mesh)
            return v[:, kv_heads] if k in ("wk", "wv") else v[kv_heads]
        p = dict(params, **{k: replicated(k) for k in ("wk", "wv", "bk", "bv")
                            if k in params})
        for k in ("q_norm", "k_norm"):
            if k in params:
                p[k] = {"scale": shardlib.copy_to(params[k]["scale"],
                                                  "model", mesh)}

    def proj(w):             # "bsd,dhe->bshe"
        return (x @ w.to(dt).reshape(dm, -1)).view(b, s, *w.shape[1:])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"]["scale"], cfg.norm_eps)
    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)
    if tp is not None and tp[3] is not None:
        # Heads that flash's grouping would pair wrongly: one KV head each.
        idx = torch.tensor(tp[3], device=k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return q, k, v.contiguous()


def _counts_from_zero(positions: torch.Tensor) -> bool:
    """Whether every row of positions (B, S) is 0, 1, ..., S - 1."""
    ar = torch.arange(positions.shape[-1], device=positions.device)
    return bool(torch.equal(positions.long(), ar.expand_as(positions)))


def _softcap(cfg: ModelConfig) -> Optional[float]:
    """The logit softcap the core applies: MLA takes none, as the
    reference's MLA prefill passes none."""
    return None if cfg.mla is not None else cfg.attn_logit_softcap


def _kernel_gap(cfg: ModelConfig, positions, head_dim: int,
                v_head_dim: Optional[int] = None) -> Optional[str]:
    """What keeps the flash kernel from this call on the card, or None.
    ``v_head_dim`` defaults to ``head_dim``."""
    dv = head_dim if v_head_dim is None else v_head_dim
    if not _counts_from_zero(positions):
        return "positions that do not count from 0 in the flash kernel"
    if (head_dim, dv) not in FLASH_SHAPES:
        dims = str(head_dim) if dv == head_dim else f"{head_dim}/{dv}"
        return f"head dim {dims} in the flash kernel"
    return None


def _core(q, k, v, positions, cfg: ModelConfig, *, causal: bool,
          window: Optional[int]):
    """The attention core over a full sequence: the flash op where the
    kernel takes the call (on the CPU, any head dims: the op runs its
    plain version), else the blockwise schedule on the CPU; on the card
    anything else raises."""
    gap = _kernel_gap(cfg, positions, q.shape[-1], v.shape[-1])
    cpu = q.device.type == "cpu"
    if gap is None or (cpu and gap.startswith("head dim")):
        return ops.flash_attention_op(q, k, v, causal=causal, window=window,
                                      softcap=_softcap(cfg))
    if cpu:
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   q_positions=positions,
                                   kv_positions=positions,
                                   softcap=_softcap(cfg))
    raise NotImplementedError(f"attention on the card needs {gap}, "
                              "which is not ported")


def attention(params, x, positions, cfg: ModelConfig, *,
              kind: str = "attn", causal: bool = True,
              return_cache: bool = False):
    """Full-sequence attention. kind: 'attn' (full) or 'local' (windowed)."""
    if cfg.attention_impl not in ("blockwise", "proj_only"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    if cfg.mla is not None:
        return _mla_attention(params, x, positions, cfg,
                              return_cache=return_cache)
    q, k, v = _project_qkv(params, x, cfg, positions)
    window = cfg.sliding_window if kind == "local" else None
    if cfg.attention_impl == "proj_only":
        # Dry-run accounting mode: projections kept, the core replaced by
        # a shape-correct pass-through (its cost is added analytically).
        out = v.repeat_interleave(cfg.num_heads // cfg.num_kv_heads, dim=2)
    else:
        out = _core(q, k, v, positions, cfg, causal=causal, window=window)
    y = output_projection(out, params["wo"], cfg)
    if return_cache:
        return y, KVCacheView(k, v, positions.to(torch.int32))
    return y


def output_projection(out, wo, cfg: ModelConfig):
    """The heads' output ``out`` (B, S, heads, e) through ``wo`` (heads, e,
    d); by rows where ``wo`` is this rank's block of heads on ``model``
    (each rank's heads give a part of the output, summed over it)."""
    b, s = out.shape[:2]
    w = wo.to(cfg.cdtype).reshape(-1, wo.shape[-1])
    tp = shardlib.model_block(wo.shape[0], cfg.num_heads)
    if tp is None:
        return out.reshape(b, s, -1) @ w
    return shardlib.row_parallel(out.reshape(b, s, -1), w, tp[0])


def _mla_q(params, x, positions, cfg: ModelConfig, mesh=None):
    """MLA's query: (q_nope, q_rope), q_rope rotated; x (B, S, d). With
    ``mesh``, the heads of this rank's block of ``q_up``, the latent
    entering them through ``copy_to``."""
    m = cfg.mla
    dt = cfg.cdtype
    b, s, _ = x.shape
    cq = rms_norm(x @ params["q_down"].to(dt), params["q_norm"]["scale"],
                  cfg.norm_eps)
    if mesh is not None:
        cq = shardlib.copy_to(cq, "model", mesh)
    q = (cq @ params["q_up"].to(dt).reshape(m.q_lora_rank, -1)).view(
        b, s, params["q_up"].shape[1], -1)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    return q_nope, apply_rope(q_rope, positions, theta=cfg.rope_theta)


def _mla_latent(params, x, positions, cfg: ModelConfig, mesh=None):
    """MLA's compressed K/V: (c_kv normalised (B, S, r), k_rope rotated
    (B, S, 1, rope)); with ``mesh``, both through ``copy_to``, as they
    enter the rank's heads."""
    m = cfg.mla
    ckv = x @ params["kv_down"].to(cfg.cdtype)
    c_kv, k_rope = ckv.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_kv = rms_norm(c_kv, params["kv_norm"]["scale"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        theta=cfg.rope_theta)
    if mesh is not None:
        c_kv = shardlib.copy_to(c_kv, "model", mesh)
        k_rope = shardlib.copy_to(k_rope, "model", mesh)
    return c_kv, k_rope


def _mla_attention(params, x, positions, cfg: ModelConfig, *,
                   return_cache: bool = False):
    """DeepSeek-V2 multi-head latent attention, the expanded form: K/V of
    every head from the latent, the core at query/key heads of
    nope + rope over value heads of v_head_dim.

    Tensor-parallel where ``q_up``, ``kv_up`` and ``wo`` are this rank's
    block of heads on ``model``: the latents every head reads (``c_q``,
    ``c_kv`` and ``k_rope``, from the replicated ``q_down``, ``kv_down``
    and their norms) are computed whole on every rank and enter the
    rank's heads through ``copy_to``, so their gradients sum every rank's
    heads; ``wo`` goes by rows (:func:`output_projection`)."""
    m = cfg.mla
    dt = cfg.cdtype
    b, s, _ = x.shape
    h = params["q_up"].shape[1]
    tp = shardlib.model_block(h, cfg.num_heads)
    mesh = None if tp is None else tp[0]
    q_nope, q_rope = _mla_q(params, x, positions, cfg, mesh)
    c_kv, k_rope = _mla_latent(params, x, positions, cfg, mesh)
    kv = (c_kv @ params["kv_up"].to(dt).reshape(m.kv_lora_rank, -1)).view(
        b, s, h, -1)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    if cfg.attention_impl == "proj_only":
        out = v        # dry-run accounting mode (core added analytically)
    else:
        out = _core(q, k, v.contiguous(), positions, cfg, causal=True,
                    window=None)
    y = output_projection(out, params["wo"], cfg)
    if return_cache:
        # MLA caches the compressed latents: (c_kv | k_rope) per position.
        lat = torch.cat([c_kv, k_rope[:, :, 0, :]], -1)[:, :, None, :]
        return y, KVCacheView(lat, x.new_zeros((b, s, 1, 0)),
                              positions.to(torch.int32))
    return y


# ---------------------------------------------------------------------------
# Decode (single-token) attention against a dense-view cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, kind: str,
               device=None) -> KVCacheView:
    """An empty cache for one layer in the compute dtype: zeros, every tag
    -1. A ``local`` layer keeps ``min(max_len, sliding_window)`` slots.
    MLA keeps the latent (B, max_len, 1, kv_lora + rope) in ``k`` and a
    (B, max_len, 1, 0) ``v``."""
    if cfg.mla is not None:
        m = cfg.mla
        lat = m.kv_lora_rank + m.qk_rope_head_dim
        return KVCacheView(
            k=torch.zeros((batch, max_len, 1, lat), dtype=cfg.cdtype,
                          device=device),
            v=torch.zeros((batch, max_len, 1, 0), dtype=cfg.cdtype,
                          device=device),
            kv_pos=torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device))
    size = min(max_len, cfg.sliding_window) if (
        kind == "local" and cfg.sliding_window) else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim_)
    return KVCacheView(
        k=torch.zeros(shape, dtype=cfg.cdtype, device=device),
        v=torch.zeros(shape, dtype=cfg.cdtype, device=device),
        kv_pos=torch.full((batch, size), -1, dtype=torch.int32,
                          device=device))


def decode_attention(params, x, cache: KVCacheView, cur_pos,
                     cfg: ModelConfig, *, kind: str = "attn"
                     ) -> Tuple[torch.Tensor, KVCacheView]:
    """One decode step. x: (B, 1, d_model); cur_pos: (B,) current position.

    Writes the step's K/V and tag into ``cache`` in place, at slot
    ``cur_pos % cache_len``, then attends over every slot whose tag the
    mask admits. Returns ``(y, cache)``, the cache being the same tensors.
    """
    if cfg.mla is not None:
        return _mla_decode(params, x, cache, cur_pos, cfg)
    dt = cfg.cdtype
    b = x.shape[0]
    kv, g, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim_
    positions = cur_pos[:, None]
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)

    slot = (cur_pos % cache.k.shape[1]).long()
    bidx = torch.arange(b, device=x.device)
    cache.k[bidx, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[bidx, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.kv_pos[bidx, slot] = cur_pos.to(torch.int32)

    window = cfg.sliding_window if kind == "local" else None
    # Scores in fp32 from the bf16 operands (the reference's
    # preferred_element_type=float32).
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     q.reshape(b, 1, kv, g, hd).float(),
                     cache.k.float()) * hd ** -0.5
    if cfg.attn_logit_softcap:
        s = torch.tanh(s / cfg.attn_logit_softcap) * cfg.attn_logit_softcap
    s = s + _mask(positions, cache.kv_pos, True, window)[:, None, None]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(dt), cache.v.to(dt))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, kv * g * hd)
    y = out @ params["wo"].to(dt).reshape(-1, x.shape[-1])
    return y, cache


def _mla_decode(params, x, cache: KVCacheView, cur_pos, cfg: ModelConfig):
    """Absorbed MLA decode: attend in the compressed latent space.

    The cache holds (c_kv | k_rope) of kv_lora + rope per position; the
    step writes its latent and tag in place. Scores absorb kv_up's key half
    into the query; values attend over c_kv, then expand with kv_up's value
    half (DeepSeek-V2 section 2.1).
    """
    m = cfg.mla
    dt = cfg.cdtype
    b = x.shape[0]
    r = m.kv_lora_rank
    positions = cur_pos[:, None]
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    c_new, k_rope_new = _mla_latent(params, x, positions, cfg)
    lat_new = torch.cat([c_new, k_rope_new[:, :, 0, :]], -1)

    slot = (cur_pos % cache.k.shape[1]).long()
    bidx = torch.arange(b, device=x.device)
    cache.k[bidx, slot, 0] = lat_new[:, 0].to(cache.k.dtype)
    cache.kv_pos[bidx, slot] = cur_pos.to(torch.int32)
    c_kv, k_rope = cache.k[:, :, 0, :r], cache.k[:, :, 0, r:]

    w_up = params["kv_up"].to(dt)
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope,
                         w_up[:, :, :m.qk_nope_head_dim])
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    # Scores in fp32 from the compute-dtype operands.
    s = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(), c_kv.float())
         + torch.einsum("bqhe,bse->bhqs", q_rope.float(),
                        k_rope.float())) * scale
    s = s + _mask(positions, cache.kv_pos, True, None)[:, None]
    p = torch.softmax(s, dim=-1)
    lat_out = torch.einsum("bhqs,bsr->bqhr", p.to(dt), c_kv.to(dt))
    out = torch.einsum("bqhr,rhe->bqhe", lat_out,
                       w_up[:, :, m.qk_nope_head_dim:])
    y = out.reshape(b, 1, -1) @ params["wo"].to(dt).reshape(-1, x.shape[-1])
    return y, cache
