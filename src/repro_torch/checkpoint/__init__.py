"""Checkpoints: atomic, manifest-driven, restorable in either package."""
from .checkpointer import Checkpointer  # noqa: F401
