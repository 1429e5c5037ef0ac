"""Optimizers and schedules (AdamW), and the int8 block format."""
from .compress import BLOCK, compression_ratio  # noqa: F401
from .optimizer import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    apply,
    global_norm,
    init,
    learning_rate,
)
