"""Models: the decoder-only prefill path (attention + dense/MoE blocks)."""
from .convert import params_from_jax  # noqa: F401
from .model import forward, init_params, param_shapes  # noqa: F401
