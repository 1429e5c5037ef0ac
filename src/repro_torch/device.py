"""Device selection for the port's entry points.

Every entry point (``DMARuntime``, ``default_runtime``, ``PagedKVCache``,
the kernel wrappers) runs on ``cuda`` unless the caller passes
``device="cpu"``. Asking for ``cuda`` on a machine without a GPU raises:
the port never carries on quietly on the CPU.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``cuda``) as a ``torch.device``; raises when it
    names CUDA and no GPU is present, or names an unsupported type."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA GPU is available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev

