"""Qwen3-14B [dense]: 40L d5120 40H (GQA kv=8) d_ff 17408 vocab 151936.

qk-norm + GQA, head_dim 128, RoPE theta 1e6. [hf:Qwen/Qwen3-8B family; hf]
"""
import dataclasses

from .base import ModelConfig
from .registry import register


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=17408, vocab_size=151936,
        qk_norm=True, rope_theta=1_000_000.0,
        block_pattern=(("attn", "dense"),),
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="qwen3-14b-reduced",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, vocab_pad_multiple=8,
    )


register("qwen3-14b", config, reduced)
