"""Architecture registry: the 10 assigned archs as selectable configs."""
from __future__ import annotations

from typing import Callable, Dict

from .base import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_REDUCED: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             reduced: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _REDUCED[name] = reduced


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]()


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from . import (  # noqa: F401
        dbrx_132b,
        deepseek_v2_236b,
        gemma3_12b,
        jamba_v0_1_52b,
        mamba2_780m,
        phi3_vision_4_2b,
        qwen2_5_3b,
        qwen3_14b,
        seamless_m4t_medium,
        starcoder2_15b,
    )
