"""Fixed-capacity submission rings of packed descriptors (runtime layer).

A :class:`SubmissionRing` is the software analogue of the DMAC driver's
in-memory descriptor region (§II-E): a circular buffer of 256-bit packed
descriptors with monotonically increasing producer (``tail``) and consumer
(``head``) counters. A slot's only completion signal is the paper's §II-D
writeback — the first 8 bytes of the descriptor overwritten with all-ones —
so a polling consumer needs no side-band state to observe progress.

Invariants:

* ``head <= tail <= head + capacity`` (counters are monotonic; the slot for
  entry ``k`` is ``k % capacity``).
* A slot is live from ``push`` until ``retire`` advances ``head`` past it.
* Retirement is **in order**: ``retire`` stops at the first not-done slot,
  exactly like a hardware ring whose head pointer chases completions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.descriptor import (
    PACKED_DTYPE,
    is_done_packed,
    mark_done_packed,
)


class RingFull(RuntimeError):
    """Submission would overrun the consumer (backpressure signal)."""


class RingEmpty(RuntimeError):
    pass


@dataclasses.dataclass
class RingEntry:
    """A retired ring entry handed back to the completion layer."""

    ticket: int
    slot: int
    descriptor: np.ndarray   # 1-element packed view (copy) of the slot
    irq: bool


class SubmissionRing:
    """Circular packed-descriptor buffer with §II-D writeback completion."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = capacity
        self.table = np.zeros(capacity, dtype=PACKED_DTYPE)
        self._tickets = np.full(capacity, -1, np.int64)
        self._irq = np.zeros(capacity, bool)
        self.head = 0   # monotonic consumer counter
        self.tail = 0   # monotonic producer counter
        # ticket -> monotonic entry index, for out-of-band completion
        # (e.g. the serve scheduler marking a request's descriptor done).
        self._by_ticket: Dict[int, int] = {}

    # -- occupancy ----------------------------------------------------------
    @property
    def occupancy(self) -> int:
        return self.tail - self.head

    @property
    def free_slots(self) -> int:
        return self.capacity - self.occupancy

    @property
    def full(self) -> bool:
        return self.free_slots == 0

    @property
    def empty(self) -> bool:
        return self.occupancy == 0

    # -- producer side ------------------------------------------------------
    def push(self, packed_row: np.ndarray, ticket: int, *,
             irq: bool = False) -> int:
        """Append one packed descriptor; returns its slot index.

        Raises :class:`RingFull` when the consumer has not yet retired the
        slot — the caller (scheduler) turns that into block-or-spill policy.
        """
        if self.full:
            raise RingFull(
                f"ring full: capacity={self.capacity} head={self.head} "
                f"tail={self.tail}")
        slot = self.tail % self.capacity
        self.table[slot] = packed_row
        self._tickets[slot] = ticket
        self._irq[slot] = irq
        self._by_ticket[ticket] = self.tail
        self.tail += 1
        return slot

    def push_table(self, table: np.ndarray, tickets, *,
                   irq=None) -> List[int]:
        """Push a whole packed table (one chain); all-or-nothing."""
        n = len(table)
        if n > self.free_slots:
            raise RingFull(
                f"need {n} slots, have {self.free_slots} "
                f"(capacity {self.capacity})")
        if irq is None:
            irq = [False] * n
        return [self.push(table[i], int(tickets[i]), irq=bool(irq[i]))
                for i in range(n)]

    # -- completion (the §II-D writeback is the ONLY signal) ----------------
    def mark_done(self, slot: int) -> None:
        mark_done_packed(self.table, slot)

    def mark_done_ticket(self, ticket: int) -> None:
        """Out-of-band completion for control descriptors (serve scheduler)."""
        entry = self._by_ticket.get(ticket)
        if entry is None or entry < self.head:
            raise KeyError(f"ticket {ticket} not live in ring")
        self.mark_done(entry % self.capacity)

    def done_mask(self) -> np.ndarray:
        """Done flags for live slots, in submission order (oldest first)."""
        idx = np.arange(self.head, self.tail) % self.capacity
        return is_done_packed(self.table[idx]) if len(idx) else \
            np.zeros(0, bool)

    def live_slots(self) -> np.ndarray:
        return np.arange(self.head, self.tail) % self.capacity

    def live_done_tickets(self) -> List[int]:
        """Tickets of live entries carrying the writeback, head order.

        The §II-D poll: a scheduler scanning the descriptor table sees
        completions immediately, even while in-order retirement is
        head-of-line blocked behind an older in-flight descriptor.
        """
        slots = self.live_slots()
        if not len(slots):
            return []
        done = is_done_packed(self.table[slots])
        return [int(self._tickets[s]) for s, d in zip(slots, done) if d]

    # -- consumer side ------------------------------------------------------
    def peek(self) -> Tuple[int, np.ndarray]:
        if self.empty:
            raise RingEmpty("ring empty")
        slot = self.head % self.capacity
        return slot, self.table[slot:slot + 1]

    def retire(self) -> List[RingEntry]:
        """Advance head past completed entries (in order); return them."""
        out: List[RingEntry] = []
        while not self.empty:
            slot = self.head % self.capacity
            if not is_done_packed(self.table[slot:slot + 1])[0]:
                break
            out.append(RingEntry(
                ticket=int(self._tickets[slot]),
                slot=slot,
                descriptor=self.table[slot:slot + 1].copy(),
                irq=bool(self._irq[slot]),
            ))
            self._by_ticket.pop(int(self._tickets[slot]), None)
            self._tickets[slot] = -1
            self.head += 1
        return out
