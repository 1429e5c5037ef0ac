"""Gemma3-12B [dense]: 48L d3840 16H (GQA kv=8) d_ff 15360 vocab 262144.

5:1 local(window 1024):global interleave, qk-norm, head_dim 256, 128k ctx.
[hf:google/gemma-3 family; unverified]
"""
import dataclasses

from .base import ModelConfig
from .registry import register

# One period = 5 sliding-window locals + 1 global; 8 periods = 48 layers.
_PATTERN = (("local", "dense"),) * 5 + (("attn", "dense"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense",
        num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
        head_dim=256, d_ff=15360, vocab_size=262144,
        qk_norm=True, rope_theta=1_000_000.0, sliding_window=1024,
        tie_embeddings=True, act_fn="gelu",
        block_pattern=_PATTERN,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="gemma3-12b-reduced",
        num_layers=6, d_model=96, num_heads=4, num_kv_heads=2,
        head_dim=24, d_ff=192, vocab_size=512, vocab_pad_multiple=8,
        sliding_window=16,
    )


register("gemma3-12b", config, reduced)
