"""Models: every family of the reference (attention with GQA, windows or
MLA, Mamba-2 SSD, the hybrid stack, encoder-decoder, the VLM prefix; dense
or MoE FFNs): prefill forward, decode caches and the decode step, and the
training loss."""
from .convert import (  # noqa: F401
    decode_state_from_jax,
    params_from_jax,
    train_state_from_jax,
)
from .model import (  # noqa: F401
    DecodeState,
    decode_step,
    forward,
    init_params,
    loss_fn,
    param_shapes,
    prefill,
)
