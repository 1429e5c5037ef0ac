"""Mamba2-780M [ssm]: 48L d1536, attention-free, vocab 50280, ssm_state 128.

SSD (state-space duality), no FFN blocks, tied embeddings.
[arXiv:2405.21060; unverified]
"""
import dataclasses

from .base import ModelConfig, SSMConfig
from .registry import register


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
        head_dim=1,  # unused (attention-free)
        d_ff=0, vocab_size=50280,
        tie_embeddings=True, norm_eps=1e-5,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        block_pattern=(("mamba", "none"),),
        vocab_pad_multiple=16,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="mamba2-780m-reduced",
        num_layers=2, d_model=64, vocab_size=512, vocab_pad_multiple=8,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=32),
    )


register("mamba2-780m", config, reduced)
