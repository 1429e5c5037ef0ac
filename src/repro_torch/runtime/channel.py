"""Virtual DMA channels: one submission ring + one engine tier each.

The paper's DMAC exposes a single frontend; related engines (iDMA,
arXiv:2305.05240) generalize this to multiple frontends feeding a shared
backend through explicit request queues. The runtime's :class:`Channel` is
that frontend: callers submit descriptor chains into the channel's ring,
and a later *drain* step executes them on the channel's engine tier:

* ``serial``     — :func:`repro_torch.core.engine.execute_serial`,
                   chain-order preserving (irregular streams with
                   overlapping writes);
* ``blocked``    — :func:`repro_torch.core.engine.execute_blocked`,
                   vectorized uniform-unit streams over 1-D pools;
* ``blocked_2d`` — :func:`repro_torch.core.engine.execute_blocked_2d` row
                   moves over row pools; with ``use_kernel=True`` the drain
                   goes through the descriptor-copy kernel
                   (:func:`repro_torch.kernels.descriptor_copy_op`), which
                   writes the destination pool in place;
* ``control``    — no data movement: entries complete only via the owner's
                   out-of-band §II-D writeback (serve-request markers).

Arbitration between channels is round-robin or smooth weighted round-robin,
mirroring the fair RR bus arbiter of the paper's §III-A testbench.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.descriptor import (
    CONFIG_IRQ_ENABLE,
    DescriptorArray,
    to_packed,
)
from repro_torch.core.speculation import DEFAULT_POLICY, DepthController
from repro_torch.core.engine import (
    execute_blocked,
    execute_blocked_2d,
    execute_serial,
)
from repro_torch.core.transform import (
    TransformSpec,
    as_transform,
    transform_source_view,
)

from repro_torch.obs.trace import Tracer, monotonic

from .completion import CompletionQueue
from .instrumentation import PerfProbe
from .ring import RingFull, SubmissionRing
from .submit import SubmitRequest, Ticket, reject_legacy_submit

TIERS = ("serial", "blocked", "blocked_2d", "control")


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    name: str
    tier: str = "serial"
    ring_capacity: int = 64
    weight: int = 1            # weighted-arbitration share
    max_len: int = 128         # serial tier: static max burst (elements)
    unit: int = 1              # blocked tier: uniform transfer unit
    use_kernel: bool = False   # blocked_2d tier: drain via the CUDA kernel

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ValueError(f"unknown tier {self.tier!r}; one of {TIERS}")
        if self.weight < 1:
            raise ValueError("channel weight must be >= 1")


@dataclasses.dataclass
class _Batch:
    """One submitted chain, pending execution on the channel's tier."""

    tickets: List[int]
    slots: List[int]
    descs: DescriptorArray
    src_pool: Optional[str]
    dst_pool: Optional[str]
    # Lowered executor from the translation cache (repro_torch.runtime.lowering);
    # None drains through the legacy tier engine.
    lowered: Optional[object] = None
    # In-flight transform riding this chain (DESIGN.md §9); None/identity
    # drains exactly as before.
    transform: Optional[TransformSpec] = None


@dataclasses.dataclass
class ChannelStats:
    submitted: int = 0         # descriptors accepted into the ring
    drained: int = 0           # descriptors executed
    batches: int = 0           # drain calls that executed work
    retired: int = 0           # ring entries retired past head
    ring_full_events: int = 0  # backpressure occurrences
    occupancy_peak: int = 0    # ring high-water mark (slots in use)
    drain_seconds: float = 0.0 # wall-clock spent executing batches
    speculation_depth: int = 0 # live §II-C depth of this channel's policy


class Channel:
    def __init__(self, cfg: ChannelConfig, completion: CompletionQueue,
                 spec: Optional[DepthController] = None):
        self.cfg = cfg
        self.ring = SubmissionRing(cfg.ring_capacity)
        self.completion = completion
        self.pending: Deque[_Batch] = deque()
        self.stats = ChannelStats()
        self.probe: Optional[PerfProbe] = None  # set via DMARuntime.attach_probe
        self.tracer: Optional[Tracer] = None    # set via DMARuntime.attach_tracer
        self.track = cfg.name                   # tracer track (shard-prefixed)
        # Per-channel speculation controller (DESIGN.md §5): the coalescer
        # asks it for layout slack before planning; the measured input hit
        # rate of each submission feeds back through observe_speculation.
        self.spec: DepthController = spec or DEFAULT_POLICY.make_controller()
        self.stats.speculation_depth = self.spec.depth

    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def speculation_depth(self) -> int:
        """Live depth of this channel's speculation policy."""
        return self.spec.depth

    def observe_speculation(self, hit_rate: float) -> int:
        """Close the §II-C feedback loop for one submission.

        The *measurer* is the coalescer (input hit rate of the submitted
        chain); the *decider* is the channel's policy controller. Depth may
        change only here — between submissions, never mid-drain.
        """
        depth = self.spec.observe(hit_rate)
        self.stats.speculation_depth = depth
        if self.probe is not None:
            self.probe.on_depth(self.name, depth)
        return depth

    # -- submission ---------------------------------------------------------
    def can_accept(self, n_descriptors: int) -> bool:
        return self.ring.free_slots >= n_descriptors

    def submit(
        self,
        d,
        tickets: Sequence[int],
        *,
        lowered: Optional[object] = None,
    ) -> Ticket:
        """Push one chain into the ring; raises RingFull under backpressure.

        Unified form (DESIGN.md §9): ``submit(SubmitRequest, tickets,
        lowered=...) -> Ticket``. ``tickets`` and ``lowered`` stay
        call-level operands (the scheduler allocates tickets and holds
        the compiled artifact). The legacy keyword form was removed one
        release after 0.4; a bare chain raises ``TypeError``.
        """
        if not isinstance(d, SubmitRequest):
            reject_legacy_submit("Channel.submit", d)
        spec = as_transform(d.transform)
        slots = self._push(d.chain, tickets, d.src_pool, d.dst_pool,
                           lowered, spec)
        return Ticket(tickets=list(map(int, tickets)),
                      channel=self.name, spilled=False,
                      slots=slots, transform=spec.cache_token)

    def _push(
        self,
        d: DescriptorArray,
        tickets: Sequence[int],
        src_pool: Optional[str],
        dst_pool: Optional[str],
        lowered: Optional[object],
        transform: Optional[TransformSpec],
    ) -> List[int]:
        n = d.num_descriptors
        if n != len(tickets):
            raise ValueError("one ticket per descriptor")
        packed = to_packed(d)
        irq = (np.asarray(d.config) & int(CONFIG_IRQ_ENABLE)) != 0
        try:
            slots = self.ring.push_table(packed, tickets, irq=irq)
        except RingFull:
            self.stats.ring_full_events += 1
            if self.probe is not None:
                self.probe.on_ring_full(self.name)
            tr = self.tracer
            if tr is not None and tickets and tr.sampled(tickets[0]):
                tr.instant("ring_full", self.track, ticket=int(tickets[0]),
                           n=n)
            raise
        self.stats.submitted += n
        occupancy = self.ring.capacity - self.ring.free_slots
        if occupancy > self.stats.occupancy_peak:
            self.stats.occupancy_peak = occupancy
        if self.probe is not None:
            self.probe.on_occupancy(self.name, occupancy)
        if self.cfg.tier != "control":
            self.pending.append(_Batch(list(map(int, tickets)), slots, d,
                                       src_pool, dst_pool, lowered,
                                       transform))
        return slots

    # -- execution ----------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.pending)

    def _execute(self, d: DescriptorArray, src: torch.Tensor,
                 dst: torch.Tensor) -> torch.Tensor:
        tier = self.cfg.tier
        if tier == "serial":
            out, _ = execute_serial(d, src, dst, max_len=self.cfg.max_len)
        elif tier == "blocked":
            out, _ = execute_blocked(d, src, dst, unit=self.cfg.unit)
        elif tier == "blocked_2d":
            if self.cfg.use_kernel:
                from repro_torch.kernels import descriptor_copy_op
                shape = dst.shape
                src2 = src.reshape(src.shape[0], -1)
                dst2 = dst.reshape(dst.shape[0], -1)
                active = np.asarray(d.length) >= 0
                sidx = np.where(active, np.asarray(d.src, np.int64), -1)
                didx = np.where(active, np.asarray(d.dst, np.int64), -1)
                out = descriptor_copy_op(sidx, didx, src2, dst2).reshape(shape)
            else:
                out, _ = execute_blocked_2d(d, src, dst)
        else:
            raise ValueError(f"tier {tier!r} carries no data")
        return out

    def _execute_transformed(self, t: Optional[TransformSpec],
                             d: DescriptorArray, src: torch.Tensor,
                             dst: torch.Tensor) -> torch.Tensor:
        """Legacy-engine drain with the in-flight transform applied.

        Read-side transforms (kv_int8, transpose) substitute the source
        pool with its transformed view; reduce_sum copies into a zero
        target (chain-order last-write-wins) and adds it into the
        destination — the semantics :func:`repro_torch.core.transform.
        reference_apply` oracles.
        """
        if t is None or t.is_identity:
            return self._execute(d, src, dst)
        if t.kind == "reduce_sum":
            copied = self._execute(d, src, torch.zeros_like(dst))
            return dst + copied
        return self._execute(d, transform_source_view(t, src), dst)

    def drain_one(self, pools: Dict[str, torch.Tensor]) -> bool:
        """Execute the oldest pending batch against the named pools.

        Mutates ``pools[dst_pool]`` with the transferred data, writes the
        §II-D completion into every ring slot of the batch, then retires
        the ring into the completion queue. Returns True if work ran.
        """
        if not self.pending:
            return self._retire()
        b = self.pending.popleft()
        src = pools[b.src_pool]
        dst = pools[b.dst_pool]
        t0 = monotonic()
        out = None
        if b.lowered is not None:
            # Translation-cache fast path: a compiled artifact for this
            # chain's signature (transform token included, so a fused
            # artifact applies the transform). It declines (None) whenever
            # substituting for the legacy engine could change a single bit.
            out = b.lowered(b.descs, src, dst, max_len=self.cfg.max_len)
        if out is None:
            out = self._execute_transformed(b.transform, b.descs, src, dst)
        pools[b.dst_pool] = out
        dt = monotonic() - t0
        for slot in b.slots:
            self.ring.mark_done(slot)
        self.stats.drained += b.descs.num_descriptors
        self.stats.batches += 1
        self.stats.drain_seconds += dt
        if self.probe is not None:
            self.probe.on_drain(self.name,
                                n_descriptors=b.descs.num_descriptors,
                                seconds=dt)
        tr = self.tracer
        if tr is not None and b.tickets and tr.sampled(b.tickets[0]):
            tr.complete("drain", self.track, t0 * 1e6, dt * 1e6,
                        ticket=b.tickets[0],
                        n=b.descs.num_descriptors,
                        lowered=b.lowered is not None)
            # every slot of the batch just received its §II-D all-ones
            # writeback (mark_done above) — one instant marks the batch
            tr.instant("writeback", self.track, ticket=b.tickets[0],
                       n_slots=len(b.slots))
        self._retire()
        return True

    def _retire(self) -> bool:
        entries = self.ring.retire()
        if entries:
            self.stats.retired += len(entries)
            self.completion.post_retired(self.name, entries)
        return False


# ---------------------------------------------------------------------------
# Arbitration
# ---------------------------------------------------------------------------

class RoundRobinArbiter:
    """Fair RR over channel names; skips ineligible channels."""

    def __init__(self, names: Sequence[str]):
        self._names = list(names)
        self._i = 0

    def pick(self, eligible: Sequence[str]) -> Optional[str]:
        if not self._names:
            return None
        eligible = set(eligible)
        for k in range(len(self._names)):
            cand = self._names[(self._i + k) % len(self._names)]
            if cand in eligible:
                self._i = (self._i + k + 1) % len(self._names)
                return cand
        return None


class WeightedArbiter:
    """Smooth weighted round-robin (nginx-style): each pick, every
    channel's credit grows by its weight; the max-credit eligible channel
    wins and pays back the total weight. Long-run selection frequencies are
    proportional to weights, with no bursts."""

    def __init__(self, weights: Dict[str, int]):
        if not weights:
            raise ValueError("need at least one channel")
        self._weights = dict(weights)
        self._credit = {k: 0 for k in weights}

    def pick(self, eligible: Sequence[str]) -> Optional[str]:
        eligible = [e for e in eligible if e in self._weights]
        if not eligible:
            return None
        for k, w in self._weights.items():
            self._credit[k] += w
        best = max(eligible, key=lambda k: (self._credit[k], k))
        self._credit[best] -= sum(self._weights.values())
        return best
