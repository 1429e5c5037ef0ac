"""Roofline analysis from the dry run's FLOP and byte counts."""
from . import analysis  # noqa: F401
