"""The unified submit contract (DESIGN.md §9).

Historically the four submission layers took divergent signatures and
returned different ticket types:

* ``Channel.submit(d, tickets, *, src_pool=, dst_pool=)``  → ``List[int]``
* ``DMARuntime.submit(d, *, src_pool=, dst_pool=, tier=)`` → ``SubmitResult``
* ``ServeEngine.submit(request)``                          → ``None``
* ``ShardedServeEngine.submit(request)``                   → ``int`` (shard)

This module defines the one contract all four now accept: a
:class:`SubmitRequest` (chain + transform + priority + completion
callback) in, a :class:`Ticket` out. The legacy keyword forms were
removed one release after 0.4 as promised: a non-``SubmitRequest``
first argument now raises ``TypeError`` at every layer
(``tools/lint_submit_api.py`` hard-fails on any resurrected form).

``Ticket`` subsumes the old ``SubmitResult`` — same leading fields in
the same positional order — so ``SubmitResult`` is now an alias and
existing unpacking/attribute code is unaffected.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

from repro_torch.core.transform import TransformLike


def reject_legacy_submit(api: str, first_arg: Any) -> None:
    """Uniform TypeError for the removed legacy keyword forms."""
    raise TypeError(
        f"{api} requires a SubmitRequest "
        "(repro_torch.runtime.SubmitRequest); the legacy keyword form was "
        f"removed one release after 0.4 (got {type(first_arg).__name__})")


@dataclasses.dataclass
class SubmitRequest:
    """One descriptor-chain (or serve-request) submission, any layer.

    ``chain`` + pool names drive the runtime/channel layers; ``request``
    carries a serve-level ``Request`` for the engine layers. ``transform``
    is anything :func:`repro_torch.core.transform.as_transform` accepts.
    ``priority > 0`` asks the scheduler to place the chain on the
    eligible channel with the most free ring slots (head-of-line
    avoidance) instead of round-robin arbitration.
    """

    chain: Any = None
    request: Any = None
    src_pool: Optional[str] = None
    dst_pool: Optional[str] = None
    channel: Optional[str] = None
    tier: Optional[str] = None
    transform: TransformLike = None
    priority: int = 0
    on_complete: Optional[Callable[[Any], None]] = None
    run_coalescer: Optional[bool] = None


@dataclasses.dataclass
class Ticket:
    """What every unified submit path returns.

    The first four fields are the old ``SubmitResult`` layout (position
    and name); the trailing fields are filled by whichever layer has
    them (``slots`` by channels, ``shard`` by the sharded engine,
    ``uid`` by the serve engines, ``transform`` whenever a non-identity
    transform rode the submission).
    """

    tickets: List[int]
    channel: str
    spilled: bool
    coalesce: Any = None
    slots: Optional[List[int]] = None
    shard: Optional[int] = None
    uid: Optional[int] = None
    transform: str = ""


#: Deprecated alias — ``DMARuntime.submit`` used to return this.
SubmitResult = Ticket
