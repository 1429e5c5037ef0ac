"""Optimizer-side utilities the port needs so far (the int8 block format)."""
from .compress import BLOCK, compression_ratio  # noqa: F401
