"""Model/shape configuration system (plain data, the reference's numbers).

Every assigned architecture is a :class:`ModelConfig`; the per-arch modules
in this package hold the exact published hyperparameters plus a ``reduced()``
variant for CPU tests. Layer stacks are described as a *block pattern* (one
period of heterogeneous blocks, repeated). ``cdtype`` and ``pdtype`` are
``torch.dtype``s; every other field and derived number is the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

# Block descriptors: (mixer, ffn)
#   mixer: "attn" | "local" (sliding window) | "mamba"
#   ffn:   "dense" | "moe"
Block = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_norm_topk: bool = True     # renormalize top-k probs (DeepSeek-style)
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    # Layer pattern: one period, repeated num_layers/len(pattern) times.
    # first_k_dense_replace: the first k layers use dense FFN even if the
    # pattern says MoE (DeepSeek layer 0).
    block_pattern: Tuple[Block, ...] = (("attn", "dense"),)
    first_k_dense: int = 0
    # Attention flavour
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0              # fraction of head_dim rotated
    sliding_window: Optional[int] = None    # for "local" blocks
    attn_logit_softcap: Optional[float] = None
    mla: Optional[MLAConfig] = None
    # Mixture of experts
    moe: Optional[MoEConfig] = None
    # State space
    ssm: Optional[SSMConfig] = None
    # Encoder-decoder
    encoder_layers: int = 0                 # >0 -> enc-dec model
    # Multimodal prefix stub (precomputed patch/frame embeddings)
    prefix_len: int = 0
    # Numerics / misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    mlp_gated: bool = True                  # SwiGLU/GeGLU vs plain 2-matmul MLP
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    act_fn: str = "silu"                    # silu | gelu
    remat_policy: str = "minimal"           # none | minimal | full
    # blockwise: the flash-style schedule; proj_only: skip the attention core
    # (the reference's dry-run accounting mode; the port runs "blockwise")
    attention_impl: str = "blockwise"
    # The reference's choice of scanned vs unrolled periods; the port always
    # runs periods as a Python loop.
    scan_periods: bool = True
    vocab_pad_multiple: int = 128

    # -- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return int(math.ceil(self.vocab_size / m) * m)

    @property
    def num_periods(self) -> int:
        assert self.num_layers % len(self.block_pattern) == 0, (
            f"{self.name}: {self.num_layers} layers not divisible by pattern "
            f"of {len(self.block_pattern)}")
        return self.num_layers // len(self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    def has_mixer(self, kind: str) -> bool:
        return any(m == kind for m, _ in self.block_pattern)

    @property
    def attention_free(self) -> bool:
        return not (self.has_mixer("attn") or self.has_mixer("local"))

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / mostly-sliding-window."""
        n_full = sum(1 for m, _ in self.block_pattern if m == "attn")
        return self.family in ("ssm", "hybrid") or (
            self.sliding_window is not None
            and n_full <= len(self.block_pattern) // 2)

    # -- parameter counting (for roofline MODEL_FLOPS) ----------------------
    def param_counts(self) -> dict:
        """Approximate parameter counts: total and active-per-token."""
        d, hd = self.d_model, self.head_dim_
        counts = {"embed": self.padded_vocab * d *
                  (1 if self.tie_embeddings else 2)}
        per_layer_total = per_layer_active = 0.0
        for mixer, ffn in self.block_pattern:
            if mixer in ("attn", "local"):
                if self.mla is not None:
                    m = self.mla
                    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                    p = (d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk
                         + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                         + m.kv_lora_rank * self.num_heads *
                         (m.qk_nope_head_dim + m.v_head_dim)
                         + self.num_heads * m.v_head_dim * d)
                else:
                    p = (d * self.num_heads * hd
                         + 2 * d * self.num_kv_heads * hd
                         + self.num_heads * hd * d)
            else:  # mamba
                s = self.ssm
                d_in = s.expand * d
                n_h = d_in // s.head_dim
                p = (d * (2 * d_in + 2 * s.n_groups * s.d_state + n_h)
                     + d_in * d + s.d_conv * (d_in + 2 * s.n_groups * s.d_state))
            mix_p = p
            if ffn == "moe":
                m = self.moe
                expert_p = 3 * d * m.expert_d_ff
                ffn_total = m.num_experts * expert_p + d * m.num_experts
                ffn_active = m.experts_per_token * expert_p
                if m.num_shared_experts:
                    sh = 3 * d * (m.shared_d_ff or m.expert_d_ff) * m.num_shared_experts
                    ffn_total += sh
                    ffn_active += sh
            elif ffn == "none":
                ffn_total = ffn_active = 0
            else:
                ffn_total = ffn_active = (3 if self.mlp_gated else 2) * d * self.d_ff
            per_layer_total += mix_p + ffn_total
            per_layer_active += mix_p + ffn_active
        n_periods = self.num_periods
        counts["layers_total"] = per_layer_total * n_periods
        counts["layers_active"] = per_layer_active * n_periods
        if self.is_encdec:  # encoder stack mirrors decoder block cost, dense
            enc = (4 * d * self.num_heads * hd + 3 * d * self.d_ff) * self.encoder_layers
            counts["layers_total"] += enc
            counts["layers_active"] += enc
        total = counts["embed"] + counts["layers_total"]
        active = counts["embed"] + counts["layers_active"]
        return {"total": total, "active": active, **counts}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode
    page_size: int = 256


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Which (arch x shape) cells run; skips are recorded in EXPERIMENTS.md."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (DESIGN.md §6)")
    return True, ""
