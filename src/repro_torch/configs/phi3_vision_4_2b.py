"""Phi-3-vision-4.2B [vlm]: 32L d3072 32H (MHA kv=32) d_ff 8192 vocab 32064.

phi3-mini backbone + CLIP vision frontend — the frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed patch embeddings as a
576-token prefix. [hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""
import dataclasses

from .base import ModelConfig
from .registry import register


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        head_dim=96, d_ff=8192, vocab_size=32064,
        rope_theta=10000.0, norm_eps=1e-5,
        prefix_len=576,           # CLIP ViT-L/14 @336px -> 24x24 patches
        block_pattern=(("attn", "dense"),),
        vocab_pad_multiple=64,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="phi-3-vision-4.2b-reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, vocab_pad_multiple=8,
        prefix_len=8,
    )


register("phi-3-vision-4.2b", config, reduced)
