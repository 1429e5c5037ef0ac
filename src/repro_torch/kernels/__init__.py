"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""
from .build import LAUNCHES, build_all, launch_counts, reset_launches  # noqa: F401
from .ops import (  # noqa: F401
    chain_copy_op,
    descriptor_copy_op,
    flash_attention_op,
    moe_combine_op,
    moe_gather_op,
    paged_attention_op,
    prefetched_chain_copy_op,
    quantize_copy_op,
)
from .adamw import (  # noqa: F401
    adamw_update,
    adamw_update_plain,
    sum_squares,
    sum_squares_plain,
)
from .descriptor_copy import (  # noqa: F401
    descriptor_copy_bucketed,
    descriptor_copy_plain,
)
from .flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_plain,
)
from .moe_dispatch import (  # noqa: F401
    moe_combine,
    moe_combine_backward,
    moe_combine_backward_plain,
    moe_combine_plain,
    moe_gather,
    moe_gather_backward,
    moe_gather_backward_plain,
    moe_gather_plain,
)
from .paged_attention import (  # noqa: F401
    paged_attention,
    paged_attention_plain,
)
from .prefetch_pipeline import (  # noqa: F401
    prefetched_chain_copy,
    prefetched_chain_copy_plain,
)
from .quantize_copy import (  # noqa: F401
    quantize_copy,
    quantize_copy_bucketed,
    quantize_copy_plain,
)
