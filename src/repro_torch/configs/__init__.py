"""Configs: the 10 assigned architectures and the shapes (plain data)."""
from .base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    shape_applicable,
)
from .registry import get_config, list_archs  # noqa: F401
