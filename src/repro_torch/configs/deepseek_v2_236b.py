"""DeepSeek-V2-236B [moe]: 60L d5120 128H, MLA kv_lora 512, vocab 102400.

MoE: 160 routed experts top-6 (expert d_ff 1536) + 2 shared experts; first
layer dense (d_ff 12288). MLA: q_lora 1536, kv_lora 512, nope 128, rope 64,
v 128. [arXiv:2405.04434; hf]
"""
import dataclasses

from .base import MLAConfig, ModelConfig, MoEConfig
from .registry import register


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
        head_dim=192,  # qk_nope(128) + qk_rope(64)
        d_ff=12288,    # dense (first-layer) FFN width
        vocab_size=102400,
        rope_theta=10000.0,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=160, experts_per_token=6, expert_d_ff=1536,
                      num_shared_experts=2, shared_d_ff=3072,
                      capacity_factor=1.25, router_norm_topk=True),
        block_pattern=(("attn", "moe"),),
        first_k_dense=1,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="deepseek-v2-236b-reduced",
        num_layers=3, d_model=64, num_heads=4, head_dim=24,
        d_ff=128, vocab_size=512, vocab_pad_multiple=8, num_kv_heads=4,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(num_experts=8, experts_per_token=2, expert_d_ff=32,
                      num_shared_experts=1, shared_d_ff=64,
                      capacity_factor=1.5),
        first_k_dense=1,
    )


register("deepseek-v2-236b", config, reduced)
