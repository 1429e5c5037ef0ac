"""StarCoder2-15B [dense]: 40L d6144 48H (GQA kv=4) d_ff 24576 vocab 49152.

GQA + RoPE (theta 1e5), attention/MLP bias, non-gated GELU MLP (2-matmul,
matching the published d_ff and ~15B param count). [arXiv:2402.19173; hf]
"""
import dataclasses

from .base import ModelConfig
from .registry import register


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
        head_dim=128, d_ff=24576, vocab_size=49152,
        qkv_bias=True, rope_theta=100_000.0, act_fn="gelu",
        mlp_gated=False, norm_eps=1e-5,
        block_pattern=(("attn", "dense"),),
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="starcoder2-15b-reduced",
        num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
        head_dim=16, d_ff=192, vocab_size=512, vocab_pad_multiple=8,
    )


register("starcoder2-15b", config, reduced)
