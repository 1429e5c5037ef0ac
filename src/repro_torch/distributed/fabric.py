"""Async fabric model for cross-shard migration (DESIGN.md §10).

PR 8's migration planner executed every cross-shard hop synchronously:
egress gather, ``drain_until_idle``, device transfer, ingress scatter,
``drain_until_idle`` — the mesh idled while each hop crossed the fabric.
This module models the interconnect explicitly so hops become
*non-blocking*: a :class:`FabricTicket` tracks each hop through
``egress -> in_flight -> ingress -> completed`` while shard-local channel
drains keep running, and per-link occupancy/latency (:class:`FabricLink`)
makes fabric contention observable instead of free.

Time is a logical *round* counter advanced by the planner's pump loop
(one round == one ``drain_all`` sweep across the mesh), so every number
here is deterministic: no wall clock, no randomness.  The overlap the
async fabric buys is measured directly — rounds where a hop was in
flight *and* some shard drained a batch are "hidden" rounds, and
``migration_overlap_ratio = hidden / in_flight`` is the gated metric.

On top of the fabric sit two policies:

* :class:`RebalancePlanner` — watches per-shard load (per-shard
  ``PerfProbe`` submitted-descriptor deltas) over a sliding window and,
  under hysteresis, emits ownership-migration plans that *spread* the
  hottest pages of the hottest shard across the other shards' free
  pages (greedy least-projected-load, with an overshoot guard so a
  single heavy page never ping-pongs between two shards).  Page heat
  decays exponentially per sample, so plans chase recent traffic, not
  all history.  Plans execute at background priority (0) so PR 8's
  weighted arbitration keeps latency-critical traffic ahead of
  rebalancing.
* Elastic resize placement (:meth:`RebalancePlanner.placement`) — when a
  shard joins or leaves, page handoff is lowered through the same
  planner: evacuated pages spread across survivors by free capacity.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# FabricTicket lifecycle states (DESIGN.md §10).
EGRESS = "egress"          # gather chains submitted, not yet drained
IN_FLIGHT = "in_flight"    # staged payload crossing the link
INGRESS = "ingress"        # scatter chains submitted on the destination
COMPLETED = "completed"    # §II-D writeback observed


@dataclasses.dataclass
class FabricLink:
    """One directed interconnect link with occupancy-based serialization.

    A send entering a busy link queues behind the in-flight payload:
    ``deliver = max(now, busy_until) + latency + pages * page_beats``.
    The counters make per-link contention exportable (Perfetto counter
    track) and feed the cycle simulator's contended mode cross-check.
    """

    src: int
    dst: int
    latency: int = 1           # rounds of pure wire latency
    page_beats: int = 1        # link-occupancy rounds per page
    busy_until: int = 0
    sends: int = 0
    pages_sent: int = 0
    busy_rounds: int = 0       # rounds the link was occupied
    queued_rounds: int = 0     # rounds sends waited behind earlier traffic

    def send(self, now: int, pages: int) -> int:
        start = max(now, self.busy_until)
        occupancy = self.latency + max(1, pages) * self.page_beats
        deliver = start + occupancy
        self.queued_rounds += start - now
        self.busy_rounds += occupancy
        self.busy_until = deliver
        self.sends += 1
        self.pages_sent += pages
        return deliver


@dataclasses.dataclass
class FabricTicket:
    """One cross-shard hop in flight through the async fabric.

    The local-gather half (egress chains) issues immediately at submit;
    the remote-scatter half (ingress chains) is submitted when the link
    delivers, and the hop completes through the destination shard's
    §II-D control-channel writeback — exactly the synchronous hop's
    completion contract, just decoupled from the caller's timeline.
    """

    hop_id: int
    src_shard: int
    dst_shard: int
    pages: int
    pool_names: Tuple[str, ...]
    rows_s: np.ndarray
    rows_d: np.ndarray
    ctrl_ticket: int
    stats: Any                       # the owning plan's MigrationStats
    priority: int = 0
    state: str = EGRESS
    # (pool, channel, tickets) per pool: how the pump detects chain drain.
    egress: List[Tuple[str, str, frozenset]] = \
        dataclasses.field(default_factory=list)
    ingress: List[Tuple[str, str, frozenset]] = \
        dataclasses.field(default_factory=list)
    staged: Dict[str, Any] = dataclasses.field(default_factory=dict)
    issued_round: int = 0
    sent_round: int = 0
    deliver_round: int = 0
    completed_round: int = 0
    inflight_rounds: int = 0         # rounds spent in IN_FLIGHT
    hidden_rounds: int = 0           # ... during which some shard drained
    merged: bool = False             # plan stats already merged globally
    # tracing (sampled per hop, deterministic)
    rec: bool = False
    flow_id: int = 0
    trace_args: Dict[str, object] = dataclasses.field(default_factory=dict)
    t0: float = 0.0
    t1: float = 0.0
    t2: float = 0.0


class AsyncFabric:
    """The mesh interconnect: directed links plus a logical round clock.

    ``advance()`` ticks the clock (the pump calls it once per drain
    sweep); ``send`` places a staged payload on its link;
    ``deliveries()`` returns tickets whose payloads have arrived and
    moves them to ``ingress``.
    """

    def __init__(self, *, latency: int = 1, page_beats: int = 1):
        if latency < 0 or page_beats < 1:
            raise ValueError("need latency >= 0 and page_beats >= 1")
        self.latency = latency
        self.page_beats = page_beats
        self.now = 0
        self.links: Dict[Tuple[int, int], FabricLink] = {}
        self.in_flight: List[FabricTicket] = []

    def link(self, src: int, dst: int) -> FabricLink:
        key = (src, dst)
        ln = self.links.get(key)
        if ln is None:
            ln = self.links[key] = FabricLink(
                src, dst, latency=self.latency, page_beats=self.page_beats)
        return ln

    def advance(self) -> int:
        self.now += 1
        return self.now

    def send(self, ticket: FabricTicket) -> int:
        ln = self.link(ticket.src_shard, ticket.dst_shard)
        ticket.sent_round = self.now
        ticket.deliver_round = ln.send(self.now, ticket.pages)
        ticket.state = IN_FLIGHT
        self.in_flight.append(ticket)
        return ticket.deliver_round

    def deliveries(self) -> List[FabricTicket]:
        out = [t for t in self.in_flight if t.deliver_round <= self.now]
        if out:
            self.in_flight = [t for t in self.in_flight
                              if t.deliver_round > self.now]
            for t in out:
                t.state = INGRESS
        return out

    def occupied_links(self) -> int:
        return sum(1 for ln in self.links.values()
                   if ln.busy_until > self.now)

    def link_stats(self) -> List[Dict[str, int]]:
        """Per-link counters, sorted by (src, dst) for stable export."""
        return [dataclasses.asdict(self.links[k])
                for k in sorted(self.links)]


class RebalancePlanner:
    """Load-driven hot-page rebalancing and resize placement.

    Feeds on per-shard load samples (``observe`` / ``observe_probes``)
    kept in a sliding window.  Hysteresis: a rebalance *episode* opens
    when the windowed max/mean load imbalance crosses ``high_water`` and
    closes when it falls back under ``low_water`` — between the two
    thresholds the planner holds its last decision, so load noise near
    one threshold cannot make it thrash.
    """

    def __init__(self, num_shards: int, *, window: int = 8,
                 high_water: float = 1.5, low_water: float = 1.1,
                 max_pages_per_plan: int = 8, heat_decay: float = 0.5):
        if num_shards < 1:
            raise ValueError("need >= 1 shard")
        if not low_water <= high_water:
            raise ValueError("need low_water <= high_water")
        if window < 1 or max_pages_per_plan < 1:
            raise ValueError("window and max_pages_per_plan must be >= 1")
        if not 0.0 <= heat_decay < 1.0:
            raise ValueError("heat_decay must be in [0, 1)")
        self.num_shards = num_shards
        self.window = window
        self.high_water = high_water
        self.low_water = low_water
        self.max_pages_per_plan = max_pages_per_plan
        self.heat_decay = heat_decay
        self._loads: List[List[float]] = [[] for _ in range(num_shards)]
        self._probe_totals: Optional[List[int]] = None
        self.page_heat: Dict[int, float] = {}
        self._episode = False
        self.plans_emitted = 0
        self.pages_planned = 0

    # -- load intake ---------------------------------------------------------
    def observe(self, per_shard_load: Sequence[float],
                hot_pages: Sequence[int] = ()) -> None:
        """One load sample per shard plus the pages touched this step."""
        if len(per_shard_load) != self.num_shards:
            raise ValueError("need one load sample per shard")
        for s, v in enumerate(per_shard_load):
            w = self._loads[s]
            w.append(float(v))
            if len(w) > self.window:
                del w[0]
        # Exponential heat decay: plans chase recent traffic, not the
        # all-time total (stale heat re-plans pages that already cooled).
        self.page_heat = {p: h * self.heat_decay
                          for p, h in self.page_heat.items()
                          if h * self.heat_decay > 0.05}
        for p in hot_pages:
            self.page_heat[int(p)] = self.page_heat.get(int(p), 0.0) + 1.0

    def observe_probes(self, probes: Sequence[Any],
                       hot_pages: Sequence[int] = ()) -> None:
        """Sample per-shard load from per-shard ``PerfProbe`` objects.

        Load is the *delta* of submitted descriptors across the shard's
        channels since the previous sample — the probe-side view of bus
        utilization (Eq. 1's numerator) without resetting the probes.
        """
        totals = [sum(c.submitted_descriptors
                      for c in probe.channels.values())
                  for probe in probes]
        prev = self._probe_totals or [0] * len(totals)
        self._probe_totals = totals
        self.observe([t - p for t, p in zip(totals, prev)], hot_pages)

    # -- imbalance / hysteresis ----------------------------------------------
    def windowed_load(self) -> List[float]:
        return [sum(w) / len(w) if w else 0.0 for w in self._loads]

    def imbalance(self) -> float:
        """Windowed max/mean load ratio (1.0 == perfectly balanced)."""
        loads = self.windowed_load()
        mean = sum(loads) / len(loads)
        if mean <= 0.0:
            return 1.0
        return max(loads) / mean

    def should_rebalance(self) -> bool:
        r = self.imbalance()
        if self._episode:
            if r <= self.low_water:
                self._episode = False
        elif r >= self.high_water:
            self._episode = True
        return self._episode

    # -- planning ------------------------------------------------------------
    def plan(self, kv, active: Optional[Sequence[bool]] = None,
             exclude: Sequence[int] = ()) -> Optional[
                 Tuple[List[int], List[int]]]:
        """One ownership-migration step: spread the hottest pages of the
        hottest shard across the other active shards' free pages.

        Greedy least-projected-load placement: each candidate page goes
        to the receiver whose projected load (windowed load plus the
        heat already routed to it this plan) is lowest, and is skipped
        entirely when moving it would leave the receiver hotter than the
        source — the overshoot guard that keeps a single Zipf-head page
        from ping-ponging between two shards forever.

        Returns ``(src_pages, dst_pages)`` for ``kv.move_pages`` at
        background priority, or None when balanced (hysteresis closed),
        when the hot shard has no movable heat, or when no receiver has
        a free page.  The caller owns reference rewriting and releasing
        the vacated source pages.
        """
        picked = self._select(kv, active, exclude)
        if picked is None:
            return None
        src, shard_of = picked
        dst: List[int] = []
        for p, s in zip(src, shard_of):
            dst.extend(kv.alloc_on(s, 1))
            # The heat moves with the content: future samples re-heat the
            # destination pages, so one hot set is never re-planned.
            self.page_heat.pop(p, None)
        self.plans_emitted += 1
        self.pages_planned += len(src)
        return src, dst

    def plan_ownership(self, kv, active: Optional[Sequence[bool]] = None,
                       exclude: Sequence[int] = ()) -> Optional[
                           Tuple[List[int], List[int]]]:
        """Ownership-first variant of :meth:`plan` (DESIGN.md §11): same
        candidate selection, but returns ``(pages, dst_shards)`` with
        *no destination allocation* — the caller flips the ownership
        table (``kv.flip_ownership``) and page contents pull lazily on
        first touch, so the rebalance decision takes effect in O(table
        write) instead of O(synchronous batch migration)."""
        picked = self._select(kv, active, exclude)
        if picked is None:
            return None
        src, shard_of = picked
        for p in src:
            self.page_heat.pop(p, None)
        self.plans_emitted += 1
        self.pages_planned += len(src)
        return src, shard_of

    def _select(self, kv, active, exclude) -> Optional[
            Tuple[List[int], List[int]]]:
        """Greedy hot-page pick shared by both plan flavors: returns
        ``(pages, receiver_shards)`` before any allocation/heat pop."""
        if not self.should_rebalance():
            return None
        loads = self.windowed_load()
        alive = [s for s in range(self.num_shards)
                 if active is None or active[s]]
        if len(alive) < 2:
            return None
        hot = max(alive, key=lambda s: (loads[s], -s))
        banned = set(int(p) for p in exclude)
        candidates = sorted(
            (p for p, h in self.page_heat.items()
             if h > 0.0 and p not in banned
             and kv.owner_of(p) == hot),
            key=lambda p: (-self.page_heat[p], p))
        receivers = [s for s in alive if s != hot]
        proj = {s: loads[s] for s in receivers}
        free = {s: kv.free_pages_on(s) for s in receivers}
        hot_proj = loads[hot]
        src: List[int] = []
        shard_of: List[int] = []
        for p in candidates:
            if len(src) >= self.max_pages_per_plan:
                break
            open_ = [s for s in receivers if free[s] > 0]
            if not open_:
                break
            h = self.page_heat[p]
            s = min(open_, key=lambda sh: (proj[sh], sh))
            if proj[s] + h > hot_proj - h:
                # Overshoot: the receiver would end hotter than the
                # source. A lighter candidate may still fit.
                continue
            src.append(p)
            shard_of.append(s)
            proj[s] += h
            hot_proj -= h
            free[s] -= 1
        if not src:
            return None
        return src, shard_of

    def placement(self, kv, pages: Sequence[int],
                  survivors: Sequence[int]) -> List[int]:
        """Resize handoff: destination pages for ``pages`` spread across
        ``survivors``, round-robin weighted by free capacity (the shard
        with the most free pages takes the next page)."""
        if not survivors:
            raise ValueError("resize placement needs at least one survivor")
        free = {s: kv.free_pages_on(s) for s in survivors}
        out: List[int] = []
        for _ in pages:
            s = max(survivors, key=lambda sh: (free[sh], -sh))
            if free[s] == 0:
                raise RuntimeError(
                    f"resize placement: survivors out of free pages "
                    f"({len(out)}/{len(pages)} placed)")
            out.extend(kv.alloc_on(s, 1))
            free[s] -= 1
        return out
