"""Polled completion queues — §II-D writeback + optional IRQ-style events.

There are no interrupts on the device (DESIGN.md §2), so completions are delivered
exactly the way the paper's frontend does when IRQs are masked: the engine
writes the all-ones sentinel into the descriptor's first 8 bytes, and a
poller observes it. On top of that, descriptors submitted with
``CONFIG_IRQ_ENABLE`` get an *event record* pushed into a per-runtime
completion queue the moment their ring entry retires — the software
analogue of the frontend's feedback logic (:func:`repro_torch.core.engine
.completion_events`), still delivered by polling, never by preemption.

Callbacks registered per ticket run synchronously inside :meth:`poll` —
callers control exactly when completion code executes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.obs.trace import Tracer, monotonic

from .ring import RingEntry


@dataclasses.dataclass(frozen=True)
class CompletionRecord:
    ticket: int
    channel: str
    slot: int
    irq: bool


class CompletionQueue:
    """FIFO of retired-descriptor events, drained by polling."""

    def __init__(self, maxlen: Optional[int] = None):
        self._events: Deque[CompletionRecord] = deque(maxlen=maxlen)
        self._callbacks: Dict[int, Callable[[CompletionRecord], None]] = {}
        self.delivered = 0
        self.dropped_irqless = 0
        self.tracer: Optional[Tracer] = None  # set via DMARuntime.attach_tracer
        self.track = "completion"

    def register(self, ticket: int,
                 callback: Callable[[CompletionRecord], None]) -> None:
        """Attach a per-descriptor callback, fired on poll after retirement."""
        self._callbacks[ticket] = callback

    def post_retired(self, channel: str, entries: List[RingEntry]) -> int:
        """Ingest retired ring entries; IRQ-enabled ones become events.

        Non-IRQ descriptors rely purely on the writeback being observed in
        the ring (mirroring hardware: no event, no trace) unless a callback
        was registered — a registered callback is an explicit request for
        notification, so those always enqueue.
        """
        n = 0
        for e in entries:
            wants_event = e.irq or e.ticket in self._callbacks
            if not wants_event:
                self.dropped_irqless += 1
                continue
            self._events.append(CompletionRecord(
                ticket=e.ticket, channel=channel, slot=e.slot, irq=e.irq))
            n += 1
        tr = self.tracer
        if n and tr is not None and tr.sampled(entries[0].ticket):
            tr.instant("retire", self.track, channel=channel, n_events=n,
                       first_ticket=int(entries[0].ticket))
        return n

    def __len__(self) -> int:
        return len(self._events)

    def poll(self, max_events: Optional[int] = None) -> List[CompletionRecord]:
        """Drain up to ``max_events`` records, firing callbacks in order."""
        tr = self.tracer
        t0 = monotonic() if tr is not None else 0.0
        out: List[CompletionRecord] = []
        while self._events and (max_events is None or len(out) < max_events):
            rec = self._events.popleft()
            cb = self._callbacks.pop(rec.ticket, None)
            if cb is not None:
                cb(rec)
            out.append(rec)
            self.delivered += 1
        if out and tr is not None and tr.sampled(out[0].ticket):
            tr.complete("completion.poll", self.track, t0 * 1e6,
                        (monotonic() - t0) * 1e6,
                        n_events=len(out), first_ticket=int(out[0].ticket))
        return out
