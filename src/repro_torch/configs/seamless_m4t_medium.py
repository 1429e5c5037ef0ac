"""SeamlessM4T-medium [audio]: enc-dec 12L+12L d1024 16H (MHA) d_ff 4096,
vocab 256206. The audio frontend is a STUB per the assignment: the encoder
consumes precomputed frame embeddings from ``input_specs()``.
[arXiv:2308.11596; hf]
"""
import dataclasses

from .base import ModelConfig
from .registry import register


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        num_layers=12, encoder_layers=12,
        d_model=1024, num_heads=16, num_kv_heads=16,
        head_dim=64, d_ff=4096, vocab_size=256206,
        rope_theta=10000.0, act_fn="gelu", norm_eps=1e-5,
        block_pattern=(("attn", "dense"),),
        vocab_pad_multiple=2,   # 256206 -> 256206 (even); keep exact-ish
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="seamless-m4t-medium-reduced",
        num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        vocab_pad_multiple=8,
    )


register("seamless-m4t-medium", config, reduced)
