"""Unified speculation-policy layer: who decides the §II-C prefetch depth.

The paper's speculative descriptor prefetcher has one tunable — how many
sequential-address fetches may be outstanding (the ``prefetch`` column of
Table I). The reproduction historically hard-coded that depth as an ``int``
in four independent places (the cycle simulator's :class:`SimConfig`, the
analytical model, the runtime coalescer's layout planner, and the Pallas
kernels' ``depth=4``). Following the modular-frontend argument of iDMA
(arXiv 2305.05240) and XDMA (arXiv 2508.08396), the *policy* is now a
swappable module decoupled from every datapath that consumes it:

* a **policy** (:class:`FixedDepth`, :class:`AdaptiveDepth`) is an immutable
  spec — safe to embed in frozen configs and share across runs;
* a **controller** (:meth:`SpeculationPolicy.make_controller`) is the
  per-run mutable state machine. Consumers create one controller per
  measurement domain (one per simulated frontend, one per runtime channel),
  ask it :attr:`DepthController.depth` *before* planning, and feed observed
  §II-C hit rates back through :meth:`DepthController.observe`.

Feedback-loop contract (DESIGN.md §5): the *measurer* is whoever sees real
traffic (the cycle simulator's commit path, the runtime coalescer's
``input_hit_rate``), the *decider* is the controller, and depth may change
only at chain/window boundaries — never mid-flight, so outstanding
speculative fetches are always drained under the depth that issued them.

``FixedDepth(n)`` reproduces the historical integer behaviour bit-for-bit:
its controller ignores observations and every consumer degenerates to the
pre-policy code path.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Protocol, Union, runtime_checkable

#: The historical hard-coded speculation depth (SimConfig.speculation(),
#: kernels' prefetched_chain_copy_op default). Single source of truth so the
#: simulator and the kernels cannot silently diverge again.
DEFAULT_DEPTH = 4

#: Committed descriptors per depth re-evaluation window ("chain boundary"
#: granularity in the cycle simulator and the adaptive controller's natural
#: cadence). Small enough that a 200-transfer sweep cell converges well
#: before its steady-state measurement window opens.
DEPTH_WINDOW = 8


class DepthController(Protocol):
    """Per-run mutable state: current depth + hit-rate feedback."""

    @property
    def depth(self) -> int: ...

    @property
    def enabled(self) -> bool: ...

    def observe(self, hit_rate: float) -> int:
        """Feed one observed §II-C hit rate; returns the (new) depth."""
        ...


@runtime_checkable
class SpeculationPolicy(Protocol):
    """Immutable policy spec; a factory for per-run controllers."""

    def make_controller(self) -> DepthController: ...


# ---------------------------------------------------------------------------
# FixedDepth — exactly the historical integer behaviour
# ---------------------------------------------------------------------------

class _FixedController:
    __slots__ = ("_depth",)

    def __init__(self, depth: int):
        self._depth = depth

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def enabled(self) -> bool:
        return self._depth > 0

    def observe(self, hit_rate: float) -> int:
        del hit_rate  # fixed policy: observations never change the depth
        return self._depth


@dataclasses.dataclass(frozen=True)
class FixedDepth:
    """Constant speculation depth — ``FixedDepth(0)`` disables speculation.

    Bit-for-bit equivalent to the pre-policy ``prefetch: int`` plumbing.
    """

    depth: int = DEFAULT_DEPTH

    def __post_init__(self):
        if self.depth < 0:
            raise ValueError("speculation depth must be >= 0")

    def make_controller(self) -> _FixedController:
        return _FixedController(self.depth)


#: Shared default policy instance (kernels, runtime channels).
DEFAULT_POLICY = FixedDepth(DEFAULT_DEPTH)


# ---------------------------------------------------------------------------
# AdaptiveDepth — EWMA of observed hit rate with hysteresis
# ---------------------------------------------------------------------------

class _AdaptiveController:
    __slots__ = ("_p", "_depth", "_ewma", "_hi", "_lo", "_updates")

    def __init__(self, p: "AdaptiveDepth"):
        self._p = p
        self._depth = p.initial_depth
        self._ewma: float | None = None
        self._hi = 0        # consecutive windows at/above deepen_threshold
        self._lo = 0        # consecutive windows at/below backoff_threshold
        self._updates = 0

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def enabled(self) -> bool:
        # min_depth >= 1: the controller always keeps one probing slot, so
        # it can re-observe the stream and recover after backing off.
        return True

    @property
    def ewma(self) -> float | None:
        return self._ewma

    def observe(self, hit_rate: float) -> int:
        p = self._p
        h = min(1.0, max(0.0, float(hit_rate)))
        self._ewma = h if self._ewma is None \
            else p.alpha * h + (1.0 - p.alpha) * self._ewma
        self._updates += 1
        if self._ewma >= p.deepen_threshold:
            self._hi += 1
            self._lo = 0
            if self._hi >= p.deepen_hysteresis:
                self._depth = min(self._depth * 2, p.max_depth)
                self._hi = 0
        elif self._ewma <= p.backoff_threshold:
            self._lo += 1
            self._hi = 0
            if self._lo >= p.backoff_hysteresis:
                self._depth = max(self._depth // 2, p.min_depth)
                self._lo = 0
        else:
            # Dead band: a misprediction burst that only dents the EWMA
            # resets the streaks instead of thrashing the depth.
            self._hi = 0
            self._lo = 0
        return self._depth


@dataclasses.dataclass(frozen=True)
class AdaptiveDepth:
    """EWMA-of-hit-rate controller: deepen on sequential streams, back off
    on MoE-storm-like irregular traffic, with hysteresis against thrash.

    Dynamics per observation window (one §II-C hit-rate sample):

    * ``ewma >= deepen_threshold`` for ``deepen_hysteresis`` consecutive
      windows -> depth doubles (capped at ``max_depth``);
    * ``ewma <= backoff_threshold`` for ``backoff_hysteresis`` consecutive
      windows -> depth halves (floored at ``min_depth``);
    * in the dead band between the thresholds the depth holds and both
      streak counters reset, so one bad window never moves the depth.

    The hysteresis is asymmetric by default (deepen after one good window,
    back off only after two bad ones): a sequential stream should reach its
    steady depth before a measurement window opens, while a lone
    misprediction burst — one bad window between good ones — must never
    thrash the depth. Backing off remains *prompt* (two windows) because
    wasted speculative fetches on a storm are pure bus contention.

    ``min_depth`` must stay >= 1: a zero-depth frontend stops speculating
    and therefore stops *observing*, which would latch the controller at
    zero forever. One probing slot keeps the feedback loop alive.
    """

    min_depth: int = 1
    max_depth: int = 24       # the paper's scaled config (Table I)
    initial_depth: int = DEFAULT_DEPTH
    alpha: float = 0.5        # EWMA smoothing (per DEPTH_WINDOW sample)
    deepen_threshold: float = 0.85
    backoff_threshold: float = 0.55
    deepen_hysteresis: int = 1   # windows of good traffic before deepening
    backoff_hysteresis: int = 2  # windows of storms before backing off

    def __post_init__(self):
        if self.min_depth < 1:
            raise ValueError("min_depth must be >= 1 (see class docstring)")
        if not self.min_depth <= self.initial_depth <= self.max_depth:
            raise ValueError("need min_depth <= initial_depth <= max_depth")
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if not 0.0 <= self.backoff_threshold < self.deepen_threshold <= 1.0:
            raise ValueError(
                "need 0 <= backoff_threshold < deepen_threshold <= 1")
        if self.deepen_hysteresis < 1 or self.backoff_hysteresis < 1:
            raise ValueError("hysteresis must be >= 1")

    def make_controller(self) -> _AdaptiveController:
        return _AdaptiveController(self)


# ---------------------------------------------------------------------------
# Coercions — every consumer accepts int | policy through these
# ---------------------------------------------------------------------------

PolicyLike = Union[int, SpeculationPolicy]


def as_policy(value: PolicyLike) -> SpeculationPolicy:
    """Coerce the legacy ``prefetch: int`` spelling into a policy.

    Integral types include numpy scalars (``np.int64`` etc.) — the
    pre-policy plumbing accepted them, so the coercion must too.
    """
    if isinstance(value, SpeculationPolicy) \
            and not isinstance(value, numbers.Integral):
        return value
    if isinstance(value, numbers.Integral):
        return FixedDepth(int(value))
    raise TypeError(
        f"expected an int depth or a SpeculationPolicy, got {value!r}")


def static_depth(value: PolicyLike) -> int:
    """The depth a consumer without a feedback path should use (kernels,
    analytical model): a fresh controller's initial depth."""
    return as_policy(value).make_controller().depth
