"""Qwen2.5-3B [dense]: 36L d2048 16H (GQA kv=2) d_ff 11008 vocab 151936.

GQA with QKV bias, head_dim 128, tied embeddings. [hf:Qwen/Qwen2.5 family; hf]
"""
import dataclasses

from .base import ModelConfig
from .registry import register


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
        head_dim=128, d_ff=11008, vocab_size=151936,
        qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
        block_pattern=(("attn", "dense"),),
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="qwen2.5-3b-reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, vocab_pad_multiple=8,
    )


register("qwen2.5-3b", config, reduced)
