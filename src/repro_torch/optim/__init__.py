"""Optimizers, schedules, gradient compression."""
from .compress import (  # noqa: F401
    BLOCK,
    compress_allreduce_leaf,
    compressed_psum_tree,
    compression_ratio,
    init_residuals,
)
from .optimizer import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    apply,
    global_norm,
    init,
    learning_rate,
)
