"""The DMA runtime scheduler: pools, backpressure, and batch drain.

:class:`DMARuntime` is the single object workload code talks to. It owns

* **named pools** — tensors on the runtime's device, registered once;
  descriptors address pool elements/rows, so submissions are (chain,
  src_pool, dst_pool) triples;
* **N virtual channels** (:mod:`repro_torch.runtime.channel`), picked by
  explicit name or by the configured arbiter;
* **the coalescer** (:mod:`repro_torch.runtime.coalesce`) — run on every serial/
  blocked submission; its per-batch §II-C hit-rate estimate and merge ratio
  accumulate into runtime stats;
* **backpressure** — a full ring either *blocks* (the submitter drains the
  channel until space frees, the paper's driver busy-wait) or *spills*
  into an unbounded software queue replayed at the next drain;
* **batch drain** — :meth:`drain_all` advances every channel; row-move
  batches that share a (src, dst) pool pair are fused and executed in one
  engine call (the "single doorbell" step).

The runtime has a device (``cuda`` unless the caller passes
``device="cpu"``); every pool must lie on it. Drains may update a pool in
place (the JAX package rebinds ``pools[name] = out``), so two pool names
may not share storage: :meth:`DMARuntime.register_pool` raises instead.

Launch-side cost is tracked per descriptor (wall-clock submit latency,
which on the card is the time to enqueue, not to finish).
"""
from __future__ import annotations

import dataclasses
import functools
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.descriptor import CONFIG_IRQ_ENABLE, DescriptorArray
from repro_torch.core.engine import execute_blocked_2d
from repro_torch.core.speculation import (
    DEFAULT_POLICY,
    PolicyLike,
    SpeculationPolicy,
    as_policy,
)
from repro_torch.core.transform import TransformSpec, as_transform

from repro_torch.obs.counters import PerfCounters, namespaced
from repro_torch.obs.trace import Tracer, monotonic

from .channel import (
    Channel,
    ChannelConfig,
    RoundRobinArbiter,
    WeightedArbiter,
)
from .coalesce import CoalesceStats, coalesce
from .completion import CompletionQueue, CompletionRecord
from .instrumentation import PerfProbe
from .lowering import TranslationCache, disabled_stats
from .ring import RingFull
from .submit import SubmitRequest, SubmitResult, Ticket, reject_legacy_submit
from repro_torch.device import resolve_device

__all__ = [
    "DMARuntime", "SubmitRequest", "SubmitResult", "Ticket",
    "default_runtime",
]


@dataclasses.dataclass
class _Spilled:
    d: DescriptorArray
    tickets: List[int]
    channel: str
    src_pool: Optional[str]
    dst_pool: Optional[str]
    transform: Optional[TransformSpec] = None


def _is_sequential_chain(d: DescriptorArray) -> bool:
    n = d.num_descriptors
    want = np.concatenate([np.arange(1, n), [-1]])
    return bool(np.array_equal(np.asarray(d.nxt), want))


@functools.lru_cache(maxsize=256)
def _split_bounds(n: int, piece: int) -> Tuple[Tuple[int, int], ...]:
    """Memoized cut points for ring-sized chunking (shape-only)."""
    return tuple((lo, min(lo + piece, n)) for lo in range(0, n, piece))


def _split_chain(d: DescriptorArray, piece: int) -> List[DescriptorArray]:
    """Cut a chain into ring-sized sequentially-chained pieces."""
    return [DescriptorArray.create(
        d.src[lo:hi], d.dst[lo:hi], d.length[lo:hi],
        config=d.config[lo:hi])
        for lo, hi in _split_bounds(d.num_descriptors, piece)]


class DMARuntime:
    def __init__(
        self,
        channels: Sequence[ChannelConfig],
        *,
        arbitration: str = "round_robin",   # "round_robin" | "weighted"
        backpressure: str = "block",        # "block" | "spill"
        coalesce_max_len: int = 1 << 20,
        speculation: Optional[PolicyLike] = None,
        translation: "bool | TranslationCache" = True,
        device=None,
    ):
        self.device = resolve_device(device)
        if not channels:
            raise ValueError("need at least one channel")
        if backpressure not in ("block", "spill"):
            raise ValueError(f"unknown backpressure policy {backpressure!r}")
        # One speculation policy per runtime, one *controller* per channel:
        # each channel adapts to its own traffic (DESIGN.md §5). The default
        # FixedDepth policy reproduces the pre-policy runtime bit-for-bit.
        self.speculation: SpeculationPolicy = as_policy(
            DEFAULT_POLICY if speculation is None else speculation)
        self.completion = CompletionQueue()
        self.channels: Dict[str, Channel] = {
            c.name: Channel(c, self.completion,
                            spec=self.speculation.make_controller())
            for c in channels}
        if arbitration == "round_robin":
            self.arbiter = RoundRobinArbiter([c.name for c in channels])
        elif arbitration == "weighted":
            self.arbiter = WeightedArbiter(
                {c.name: c.weight for c in channels})
        else:
            raise ValueError(f"unknown arbitration {arbitration!r}")
        self.backpressure = backpressure
        self.coalesce_max_len = coalesce_max_len
        # Chain-lowering JIT (DESIGN.md §7): signature-keyed cache of
        # compiled drain executors + digest-keyed coalescer-plan memo.
        # True builds a private cache; a TranslationCache instance may be
        # shared across runtimes (sharded serving); False disables lowering
        # entirely (the --no-translation-cache A/B escape hatch).
        if translation is True:
            self.translation: Optional[TranslationCache] = TranslationCache()
        elif translation is False or translation is None:
            self.translation = None
        else:
            self.translation = translation
        self.probe: Optional[PerfProbe] = None
        self.tracer: Optional[Tracer] = None
        self.pools: Dict[str, torch.Tensor] = {}
        self._spill: Deque[_Spilled] = deque()
        self._next_ticket = 0
        self._ticket_channel: Dict[int, str] = {}
        # launch-side accounting (paper: launch latency, Table IV i-rf)
        self.submitted_descriptors = 0
        self.launch_seconds = 0.0
        self.coalesce_in = 0
        self.coalesce_out = 0
        self._hit_rates: List[float] = []

    # -- instrumentation ----------------------------------------------------
    def attach_probe(self, probe: Optional[PerfProbe]) -> None:
        """Attach (or with None, detach) a perf counter sink.

        The probe observes every channel of this runtime; the perf sweep
        (the ``dma`` sweep, not ported yet) reads its snapshot instead of re-deriving
        counters from submission-side bookkeeping.
        """
        self.probe = probe
        for ch in self.channels.values():
            ch.probe = probe
        if self.translation is not None:
            self.translation.attach_probe(probe)

    def attach_tracer(self, tracer: Optional[Tracer], *,
                      track_prefix: str = "") -> None:
        """Attach (or with None, detach) a lifecycle span tracer.

        Propagates to every channel, the completion queue, and the
        translation cache. ``track_prefix`` namespaces this runtime's
        tracks — the sharded runtime passes ``"shard{i}/"`` so an exported
        timeline shows one track group per shard (DESIGN.md §8).
        """
        self.tracer = tracer
        for ch in self.channels.values():
            ch.tracer = tracer
            ch.track = track_prefix + ch.name
        self.completion.tracer = tracer
        self.completion.track = track_prefix + "completion"
        if self.translation is not None:
            self.translation.attach_tracer(tracer)

    # -- pools --------------------------------------------------------------
    def register_pool(self, name: str, array: torch.Tensor) -> None:
        """Register (or replace) pool ``name``.

        The tensor must lie on the runtime's device, and may not share
        storage with a pool registered under another name (drains write
        pools in place; register a clone instead).
        """
        if not isinstance(array, torch.Tensor):
            raise TypeError(f"pool {name!r} must be a torch.Tensor")
        if array.device.type != self.device.type or (
                self.device.type == "cuda"
                and array.device.index != self.device.index):
            raise ValueError(f"pool {name!r} lies on {array.device}; this "
                             f"runtime runs on {self.device}")
        ptr = array.untyped_storage().data_ptr()
        for other, t in self.pools.items():
            if other != name and t.numel() and array.numel() \
                    and t.untyped_storage().data_ptr() == ptr:
                raise ValueError(f"pool {name!r} shares storage with pool "
                                 f"{other!r}; register a clone")
        self.pools[name] = array

    def register_numpy_pools(self, arrays: Dict[str, np.ndarray]) -> None:
        """Register host arrays (e.g. another runtime's exported pools) as
        pools on this runtime's device, copying each."""
        for name, arr in arrays.items():
            self.register_pool(
                name, torch.from_numpy(np.array(arr, copy=True)).to(
                    self.device))

    def numpy_pools(self) -> Dict[str, np.ndarray]:
        """Host copies of every pool (the inverse of
        :meth:`register_numpy_pools`)."""
        return {name: t.detach().cpu().numpy()
                for name, t in self.pools.items()}

    def pool(self, name: str) -> torch.Tensor:
        return self.pools[name]

    # -- submission ---------------------------------------------------------
    def _take_tickets(self, n: int, channel: str) -> List[int]:
        t = list(range(self._next_ticket, self._next_ticket + n))
        self._next_ticket += n
        for tk in t:
            self._ticket_channel[tk] = channel
        return t

    def _pick_channel(self, tier: Optional[str], priority: int = 0) -> str:
        eligible = [name for name, ch in self.channels.items()
                    if tier is None or ch.cfg.tier == tier]
        if not eligible:
            raise ValueError(f"no channel with tier {tier!r}")
        if priority > 0:
            # High-priority submissions bypass arbitration and take the
            # eligible channel with the most free ring slots (head-of-line
            # avoidance); ties break on name for determinism.
            return min(eligible,
                       key=lambda n: (-self.channels[n].ring.free_slots, n))
        name = self.arbiter.pick(eligible)
        return name if name is not None else eligible[0]

    def submit(self, d, **kw) -> Ticket:
        """Plan a chain and enqueue it on a channel ring.

        Unified form (DESIGN.md §9): ``submit(SubmitRequest) -> Ticket``,
        carrying chain + pools + transform + priority + completion
        callback. The legacy keyword form
        ``submit(chain, src_pool=..., dst_pool=..., tier=...)`` was
        removed one release after 0.4 and now raises ``TypeError``.

        Returns tickets (one per *planned* descriptor; the last ticket of
        a submission always exists, so callers wanting one completion per
        logical transfer hang their callback on ``tickets[-1]``).
        """
        if not isinstance(d, SubmitRequest):
            reject_legacy_submit("DMARuntime.submit", d)
        if kw:
            raise TypeError(
                "unified submit takes a single SubmitRequest; put "
                f"{sorted(kw)} on the request")
        return self._submit_impl(
            d.chain, src_pool=d.src_pool, dst_pool=d.dst_pool,
            channel=d.channel, tier=d.tier, on_complete=d.on_complete,
            run_coalescer=d.run_coalescer,
            transform=as_transform(d.transform), priority=d.priority)

    def _submit_impl(
        self,
        d: DescriptorArray,
        *,
        src_pool: Optional[str] = None,
        dst_pool: Optional[str] = None,
        channel: Optional[str] = None,
        tier: Optional[str] = None,
        on_complete: Optional[Callable[[CompletionRecord], None]] = None,
        run_coalescer: Optional[bool] = None,
        transform: Optional[TransformSpec] = None,
        priority: int = 0,
    ) -> Ticket:
        spec = as_transform(transform)
        t0 = monotonic()
        n_raw = d.num_descriptors
        # Sampling key = the first ticket this submission will take; the
        # decision is made once here and reused by every child span.
        tr = self.tracer
        rec = tr is not None and tr.sampled(self._next_ticket)
        first_ticket = self._next_ticket
        name = channel if channel is not None \
            else self._pick_channel(tier, priority)
        ch = self.channels[name]

        stats: Optional[CoalesceStats] = None
        lowered = None
        if run_coalescer is None:
            # Row-move and control streams have positional semantics the
            # merge pass must not disturb; linear-byte tiers benefit.
            run_coalescer = ch.cfg.tier in ("serial", "blocked")
        if run_coalescer and d.num_descriptors:
            max_len = (ch.cfg.max_len if ch.cfg.tier == "serial"
                       else min(ch.cfg.unit, self.coalesce_max_len)
                       if ch.cfg.tier == "blocked" else self.coalesce_max_len)
            # Ask-then-observe (DESIGN.md §5): the planner provisions the
            # layout slack the channel's policy currently wants, then the
            # measured input hit rate feeds back and may move the depth —
            # for the *next* submission, never this one.
            c0 = monotonic() if rec else 0.0
            planned = None
            if self.translation is not None:
                # Chain-lowering fast path (DESIGN.md §7): plan through
                # the digest-keyed memo (bit-identical to coalesce) and
                # pick up the signature's compiled drain executor. A None
                # plan (malformed chain) falls back to the legacy walker,
                # which raises the canonical error.
                planned = self.translation.plan(
                    d, max_len=max_len, spec_depth=ch.speculation_depth,
                    tier=ch.cfg.tier, transform=spec)
            if planned is not None:
                d, stats, lowered = (planned.planned, planned.stats,
                                     planned.lowered)
            else:
                d, stats = coalesce(d, max_len=max_len,
                                    spec_depth=ch.speculation_depth,
                                    allow_merge=spec.merge_safe)
            self.coalesce_in += stats.n_in
            self.coalesce_out += stats.n_out
            self._hit_rates.append(stats.input_hit_rate)
            ch.observe_speculation(stats.input_hit_rate)
            if rec:
                tr.complete("coalesce", ch.track, c0 * 1e6,
                            (monotonic() - c0) * 1e6,
                            ticket=first_ticket, n_in=stats.n_in,
                            n_out=stats.n_out,
                            hit_rate=stats.input_hit_rate,
                            planned=planned is not None)

        n = d.num_descriptors
        if n == 0:
            dt = monotonic() - t0
            if self.probe is not None:
                self.probe.on_submit(
                    name, n_in=n_raw, n_out=0, launch_seconds=dt,
                    hit_rate=stats.input_hit_rate if stats else None)
            if rec:
                tr.complete("submit", ch.track, t0 * 1e6, dt * 1e6,
                            ticket=first_ticket, channel=name,
                            n_in=n_raw, n_out=0)
            return Ticket([], name, False, stats,
                          transform=spec.cache_token)

        # A chain longer than the ring is submitted in ring-sized pieces
        # (the driver can never map more descriptors than slots at once).
        # Safe when execution order across pieces equals chain order: true
        # for sequentially-chained streams (every coalesced chain) and for
        # the order-free blocked tiers; a serial-tier chain with arbitrary
        # `nxt` links cannot be cut, so reject it loudly instead of hanging.
        chunks = [d]
        if n > ch.ring.capacity:
            sequential = (self.translation.is_sequential(d)
                          if self.translation is not None
                          else _is_sequential_chain(d))
            if ch.cfg.tier == "serial" and not sequential:
                raise ValueError(
                    f"chain of {n} descriptors exceeds ring capacity "
                    f"{ch.ring.capacity} and is not sequentially linked; "
                    "coalesce it or enlarge the ring")
            chunks = _split_chain(d, ch.ring.capacity)
            lowered = None   # pieces have new shapes; drain them legacy

        tickets = self._take_tickets(n, name)
        if on_complete is not None:
            self.completion.register(tickets[-1], on_complete)

        spilled = False
        cursor = 0
        for piece in chunks:
            k = piece.num_descriptors
            piece_tickets = tickets[cursor:cursor + k]
            cursor += k
            while True:
                try:
                    ch.submit(SubmitRequest(chain=piece, src_pool=src_pool,
                                            dst_pool=dst_pool,
                                            transform=spec),
                              piece_tickets, lowered=lowered)
                    break
                except RingFull:
                    if self.backpressure == "block":
                        # Paper driver semantics: the submitter waits on
                        # the device; "waiting" = advancing the consumer.
                        if not ch.drain_one(self.pools) and ch.ring.full:
                            raise  # ring full of unacknowledged work
                    else:
                        self._spill.append(_Spilled(
                            piece, piece_tickets, name, src_pool, dst_pool,
                            spec))
                        spilled = True
                        break
        self.submitted_descriptors += n
        launch = monotonic() - t0
        self.launch_seconds += launch
        if self.probe is not None:
            self.probe.on_submit(
                name, n_in=n_raw, n_out=n, launch_seconds=launch,
                hit_rate=stats.input_hit_rate if stats else None)
        if rec:
            tr.complete("submit", ch.track, t0 * 1e6, launch * 1e6,
                        ticket=tickets[0], channel=name,
                        n_in=n_raw, n_out=n, spilled=spilled)
        return Ticket(tickets, name, spilled, stats,
                      transform=spec.cache_token)

    def submit_control(self, payload: int = 0, *,
                       channel: Optional[str] = None,
                       on_complete=None) -> Ticket:
        """One IRQ-enabled control descriptor (no data movement)."""
        d = DescriptorArray.create(
            [payload], [0], [0],
            nxt=[-1], config=[int(CONFIG_IRQ_ENABLE)])
        return self.submit(SubmitRequest(
            chain=d, channel=channel, tier=None if channel else "control",
            on_complete=on_complete, run_coalescer=False))

    # -- out-of-band completion (control descriptors) -----------------------
    def complete(self, ticket: int) -> None:
        """§II-D writeback for a control descriptor, by ticket."""
        name = self._ticket_channel.get(ticket)
        if name is None:
            raise KeyError(f"unknown ticket {ticket}")
        self.channels[name].ring.mark_done_ticket(ticket)

    # -- drain --------------------------------------------------------------
    def _admit_spill(self) -> None:
        still: Deque[_Spilled] = deque()
        while self._spill:
            s = self._spill.popleft()
            ch = self.channels[s.channel]
            if ch.can_accept(s.d.num_descriptors):
                ch.submit(SubmitRequest(chain=s.d, src_pool=s.src_pool,
                                        dst_pool=s.dst_pool,
                                        transform=s.transform), s.tickets)
            else:
                still.append(s)
        self._spill = still

    def drain_channel(self, name: str, max_batches: int = 1) -> int:
        ch = self.channels[name]
        ran = 0
        for _ in range(max_batches):
            if not ch.drain_one(self.pools):
                break
            ran += 1
        return ran

    def drain_all(self, max_batches_per_channel: int = 1) -> int:
        """Advance every channel one step; fuse row-move batches.

        Pending ``blocked_2d`` batches (non-kernel) across *all* channels
        that target the same (src_pool, dst_pool) pair are concatenated and
        executed in one kernel launch or :func:`execute_blocked_2d` call —
        the multi-channel doorbell. Everything else drains per channel.
        """
        ran = self._drain_fused_2d()
        for name in self.channels:
            ran += self.drain_channel(name, max_batches_per_channel)
        for ch in self.channels.values():
            ch._retire()
        self._admit_spill()
        return ran

    def _drain_fused_2d(self) -> int:
        groups: Dict[Tuple[str, str], List[Tuple[Channel, object]]] = {}
        for ch in self.channels.values():
            if ch.cfg.tier != "blocked_2d" or ch.cfg.use_kernel:
                continue
            while ch.pending:
                # Fusion concatenates descriptor streams, which is only
                # sound when every batch moves raw bytes: a transformed
                # batch stays pending and drains (with its transform) via
                # the per-channel path, blocking later batches on this
                # channel from fusing ahead of it this round.
                if ch.pending[0].transform is not None \
                        and not ch.pending[0].transform.is_identity:
                    break
                b = ch.pending.popleft()
                groups.setdefault((b.src_pool, b.dst_pool), []).append((ch, b))
        ran = 0
        for (src_name, dst_name), items in groups.items():
            # Fusion executes every batch's reads against the pre-drain
            # pool, so a batch that reads (RAW) or rewrites (WAW) a row an
            # earlier fused batch wrote must start a new fused call.
            sub: List[Tuple[Channel, object]] = []
            written: set = set()
            for ch, b in items:
                src_rows = set(np.asarray(b.descs.src).tolist())
                dst_rows = set(np.asarray(b.descs.dst).tolist())
                if sub and (src_rows & written or dst_rows & written):
                    self._execute_fused(sub, src_name, dst_name)
                    ran += len(sub)
                    sub, written = [], set()
                sub.append((ch, b))
                written |= dst_rows
            if sub:
                self._execute_fused(sub, src_name, dst_name)
                ran += len(sub)
        return ran

    def _execute_fused(self, items: List[Tuple[Channel, object]],
                       src_name: str, dst_name: str) -> None:
        descs = [b.descs for _, b in items]
        fused = DescriptorArray.create(
            torch.cat([d.src for d in descs]),
            torch.cat([d.dst for d in descs]),
            torch.cat([d.length for d in descs]),
            nxt=torch.cat([d.nxt for d in descs]),
            config=torch.cat([d.config for d in descs]),
        )
        t0 = monotonic()
        out = None
        if self.translation is not None:
            # Lowered fused drain: the whole multi-channel batch through
            # one bucketed descriptor-copy launch (declines for CPU pools
            # and on duplicate destination rows — legacy path is
            # authoritative).
            out = self.translation.execute_rows_2d(
                fused, self.pools[src_name], self.pools[dst_name])
        if out is None:
            out, _ = execute_blocked_2d(
                fused, self.pools[src_name], self.pools[dst_name])
        dt = monotonic() - t0
        self.pools[dst_name] = out
        tr = self.tracer
        if tr is not None and items[0][1].tickets \
                and tr.sampled(items[0][1].tickets[0]):
            tr.complete("drain", items[0][0].track, t0 * 1e6, dt * 1e6,
                        ticket=items[0][1].tickets[0],
                        n=fused.num_descriptors, fused=True)
        # The fused call's wall-clock is apportioned per batch by descriptor
        # share, so per-channel drain_seconds stay comparable across paths.
        total = max(fused.num_descriptors, 1)
        for ch, b in items:
            n_b = b.descs.num_descriptors
            share = dt * n_b / total
            for slot in b.slots:
                ch.ring.mark_done(slot)
            ch.stats.drained += n_b
            ch.stats.batches += 1
            ch.stats.drain_seconds += share
            if ch.probe is not None:
                ch.probe.on_drain(ch.name, n_descriptors=n_b,
                                  seconds=share, fused=True)
            ch._retire()

    def drain_until_idle(self, max_rounds: int = 1024) -> None:
        for _ in range(max_rounds):
            if not any(ch.has_work for ch in self.channels.values()) \
                    and not self._spill:
                return
            self.drain_all()
        raise RuntimeError("runtime did not quiesce")

    # -- completion-side API -------------------------------------------------
    def poll(self, max_events: Optional[int] = None):
        return self.completion.poll(max_events)

    # -- speculation ---------------------------------------------------------
    def speculation_depths(self) -> Dict[str, int]:
        """Live §II-C depth per channel (the policy's current decision)."""
        return {name: ch.speculation_depth
                for name, ch in self.channels.items()}

    # -- stats ---------------------------------------------------------------
    def _translation_stats_raw(self) -> Dict[str, object]:
        """Bare-key counter block (internal aggregation / wrapping input)."""
        if self.translation is None:
            return disabled_stats()
        return self.translation.stats()

    def translation_stats(self) -> PerfCounters:
        """Translation-cache counters, unified ``translation.*`` namespace.

        The bare-key deprecated aliases were removed one release after
        0.4 (DESIGN.md §9). Zeros + ``translation.enabled`` False when
        lowering is off.
        """
        return namespaced(self._translation_stats_raw(), "translation")

    def stats(self) -> Dict[str, object]:
        per_channel = {
            name: dataclasses.asdict(ch.stats)
            for name, ch in self.channels.items()
        }
        n = max(self.submitted_descriptors, 1)
        return {
            "channels": per_channel,
            "submitted_descriptors": self.submitted_descriptors,
            "launch_us_per_descriptor": 1e6 * self.launch_seconds / n,
            "coalesce_merge_ratio":
                (self.coalesce_in / self.coalesce_out
                 if self.coalesce_out else 1.0),
            "mean_input_hit_rate":
                float(np.mean(self._hit_rates)) if self._hit_rates else 1.0,
            "spilled": len(self._spill),
            "completions_delivered": self.completion.delivered,
            "translation_cache": self.translation_stats(),
        }


def default_runtime(
    n_channels: int = 4,
    *,
    tier: str = "blocked_2d",
    ring_capacity: int = 64,
    arbitration: str = "round_robin",
    backpressure: str = "block",
    speculation: Optional[PolicyLike] = None,
    translation: "bool | TranslationCache" = True,
    device=None,
    **channel_kw,
) -> DMARuntime:
    """N homogeneous channels — the common serving configuration, on
    ``device`` (``cuda`` unless given)."""
    cfgs = [ChannelConfig(name=f"ch{i}", tier=tier,
                          ring_capacity=ring_capacity, **channel_kw)
            for i in range(n_channels)]
    return DMARuntime(cfgs, arbitration=arbitration,
                      backpressure=backpressure, speculation=speculation,
                      translation=translation, device=device)
