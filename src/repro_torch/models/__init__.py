"""Models: every family of the reference (attention with GQA, windows or
MLA, Mamba-2 SSD, the hybrid stack, encoder-decoder, the VLM prefix; dense
or MoE FFNs): prefill forward, decode caches and the decode step."""
from .convert import decode_state_from_jax, params_from_jax  # noqa: F401
from .model import (  # noqa: F401
    DecodeState,
    decode_step,
    forward,
    init_params,
    param_shapes,
    prefill,
)
