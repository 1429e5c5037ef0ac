"""DBRX-132B [moe]: 40L d6144 48H (GQA kv=8), 16 experts top-4, vocab 100352.

Fine-grained MoE (expert d_ff 10752), head_dim 128, RoPE theta 5e5.
[hf:databricks/dbrx-base; unverified]
"""
import dataclasses

from .base import ModelConfig, MoEConfig
from .registry import register


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=10752, vocab_size=100352,
        rope_theta=500_000.0,
        moe=MoEConfig(num_experts=16, experts_per_token=4, expert_d_ff=10752,
                      capacity_factor=1.25, router_norm_topk=True),
        block_pattern=(("attn", "moe"),),
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="dbrx-132b-reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, vocab_pad_multiple=8,
        moe=MoEConfig(num_experts=4, experts_per_token=2, expert_d_ff=64,
                      capacity_factor=1.5),
    )


register("dbrx-132b", config, reduced)
