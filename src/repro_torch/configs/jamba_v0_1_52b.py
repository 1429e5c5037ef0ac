"""Jamba-v0.1-52B [hybrid]: 32L d4096 32H (GQA kv=8) d_ff 14336 vocab 65536.

Mamba:attention 7:1 interleave (attn at period offset 4), MoE 16 experts
top-2 on every other layer (odd offsets). One period = 8 layers; 4 periods.
Jamba's mixer is Mamba-1; we realize it in SSD (Mamba-2 dual) form with the
published d_state 16 — see DESIGN.md "assumptions". [arXiv:2403.19887; hf]
"""
import dataclasses

from .base import ModelConfig, MoEConfig, SSMConfig
from .registry import register


def _pattern():
    blocks = []
    for idx in range(8):
        mixer = "attn" if idx == 4 else "mamba"
        ffn = "moe" if idx % 2 == 1 else "dense"
        blocks.append((mixer, ffn))
    return tuple(blocks)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=65536,
        rope_theta=10000.0,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        moe=MoEConfig(num_experts=16, experts_per_token=2, expert_d_ff=14336,
                      capacity_factor=1.25, router_norm_topk=True),
        block_pattern=_pattern(),
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="jamba-v0.1-52b-reduced",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, vocab_pad_multiple=8,
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=32),
        moe=MoEConfig(num_experts=4, experts_per_token=2, expert_d_ff=64,
                      capacity_factor=1.5),
    )


register("jamba-v0.1-52b", config, reduced)
