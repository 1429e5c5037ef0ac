"""Low-overhead span/event recorder for descriptor-lifecycle tracing.

Design constraints (DESIGN.md §8):

* **off-by-default-cheap** — the runtime stores ``tracer = None`` and every
  hook site is a single attribute test; no object is built, no clock read,
  when tracing is off.  The overhead guard test and the ``tracing`` bench
  section in BENCH_runtime.json keep this honest.
* **bounded** — events land in a ``deque(maxlen=capacity)`` ring; the
  ``emitted`` counter keeps counting so ``dropped`` is exact.
* **sampled deterministically** — ``sampled(key)`` hashes ``seed:key`` with
  crc32 against ``sample_rate * 2**32``.  The same (seed, key) samples the
  same way on every shard and every run, so cross-shard traces of one
  request either all record or all skip.
* **dual clocks** — wall events timestamp with ``time.monotonic()``
  microseconds; simulator events pass explicit cycle timestamps with
  ``clock="cycle"`` and are rendered on separate tracks (1 cycle == 1 µs
  in the exported timeline).

:func:`region` names a stretch of the program (the train step's phases)
in ``torch.profiler``'s own trace, on the profiler's clock, so device
operations can be laid against it; with the profiler off it is a shared
null context. It enters ``_RecordFunctionFast`` rather than
``record_function``, which is a dispatched op: a checkpointed period's
selective recompute that meets one the forward did not (the profiler
started between them, or a region opened only in the recompute) makes
the backward raise. The :class:`Tracer`'s events stay on ``monotonic``
and cannot be laid onto a device trace.
"""
from __future__ import annotations

import time
import zlib
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

monotonic = time.monotonic
"""The one clock used for every wall-time measurement in the runtime.

``time.time()`` is subject to NTP steps and DST jumps; ``perf_counter``
is per-process.  ``monotonic`` is steady and comparable across the whole
process, which is all the probe and tracer need.
"""


def monotonic_us() -> float:
    return monotonic() * 1e6


_OFF = nullcontext()


def region(name: str):
    """``with region("train.forward"): ...``: a host span ``name`` in the
    profiler's trace while ``torch.profiler`` records, else the one shared
    null context (no object built, no clock read)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


@dataclass
class TraceEvent:
    """One trace_event-shaped record (pre-export, track not yet a pid)."""

    name: str
    ph: str                       # X, i, b, e, s, t, f, C
    ts: float                     # µs (wall) or cycles (clock="cycle")
    track: str                    # exported as one Perfetto process/track
    dur: Optional[float] = None   # X only
    id: Optional[int] = None      # async + flow events
    clock: str = "wall"           # "wall" | "cycle"
    args: Dict[str, object] = field(default_factory=dict)


class Tracer:
    """Ring-buffered event recorder with seeded sampling.

    All emit helpers are unconditional — *callers* gate on
    ``tracer is not None and tracer.sampled(key)`` so the disabled path
    stays one attribute load.
    """

    def __init__(self, capacity: int = 65536, sample_rate: float = 1.0,
                 seed: int = 0) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.sample_rate = float(sample_rate)
        self.seed = seed
        self.emitted = 0
        self._buf: deque = deque(maxlen=capacity)
        self._next_flow = 1
        self._threshold = int(min(max(self.sample_rate, 0.0), 1.0) * 2**32)

    # -- sampling ----------------------------------------------------------

    def sampled(self, key: object) -> bool:
        """Deterministic hash-based sampling decision for ``key``.

        Keys are stable identities (first ticket of a submission, request
        uid, translation-lookup ordinal) so the decision is reproducible
        and shard-independent.
        """
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        return zlib.crc32(f"{self.seed}:{key}".encode()) < self._threshold

    # -- clock -------------------------------------------------------------

    def now_us(self) -> float:
        return monotonic() * 1e6

    # -- emission ----------------------------------------------------------

    def emit(self, event: TraceEvent) -> None:
        self.emitted += 1
        self._buf.append(event)

    def complete(self, name: str, track: str, t0_us: float, dur_us: float,
                 *, clock: str = "wall", **args) -> None:
        """A closed span ("X"): began at ``t0_us``, lasted ``dur_us``."""
        self.emit(TraceEvent(name=name, ph="X", ts=t0_us, track=track,
                             dur=max(dur_us, 0.0), clock=clock, args=args))

    def instant(self, name: str, track: str, ts: Optional[float] = None,
                *, clock: str = "wall", **args) -> None:
        if ts is None:
            ts = self.now_us()
        self.emit(TraceEvent(name=name, ph="i", ts=ts, track=track,
                             clock=clock, args=args))

    def counter(self, name: str, track: str, ts: Optional[float] = None,
                *, clock: str = "wall", **values) -> None:
        """A counter sample ("C"): Perfetto renders each numeric value in
        ``values`` as a series on the named counter track (per-link
        fabric occupancy uses one counter per directed link)."""
        if ts is None:
            ts = self.now_us()
        self.emit(TraceEvent(name=name, ph="C", ts=ts, track=track,
                             clock=clock, args=values))

    def async_begin(self, name: str, track: str, id: int,
                    ts: Optional[float] = None, **args) -> None:
        if ts is None:
            ts = self.now_us()
        self.emit(TraceEvent(name=name, ph="b", ts=ts, track=track, id=id,
                             args=args))

    def async_end(self, name: str, track: str, id: int,
                  ts: Optional[float] = None, **args) -> None:
        if ts is None:
            ts = self.now_us()
        self.emit(TraceEvent(name=name, ph="e", ts=ts, track=track, id=id,
                             args=args))

    def flow_start(self, name: str, track: str, id: int,
                   ts: Optional[float] = None, **args) -> None:
        if ts is None:
            ts = self.now_us()
        self.emit(TraceEvent(name=name, ph="s", ts=ts, track=track, id=id,
                             args=args))

    def flow_step(self, name: str, track: str, id: int,
                  ts: Optional[float] = None, **args) -> None:
        if ts is None:
            ts = self.now_us()
        self.emit(TraceEvent(name=name, ph="t", ts=ts, track=track, id=id,
                             args=args))

    def flow_end(self, name: str, track: str, id: int,
                 ts: Optional[float] = None, **args) -> None:
        if ts is None:
            ts = self.now_us()
        self.emit(TraceEvent(name=name, ph="f", ts=ts, track=track, id=id,
                             args=args))

    def next_flow_id(self) -> int:
        """Fresh process-unique id for one flow arrow (s -> t -> f)."""
        fid = self._next_flow
        self._next_flow += 1
        return fid

    # -- reading -----------------------------------------------------------

    @property
    def dropped(self) -> int:
        return self.emitted - len(self._buf)

    def events(self) -> List[TraceEvent]:
        return list(self._buf)

    def clear(self) -> None:
        self._buf.clear()
        self.emitted = 0
