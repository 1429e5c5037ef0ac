"""Cycle-level OOC simulator of the DMAC (§III-A testbench, Figs 4-5, Table IV).

Reproduces the paper's out-of-context evaluation: the DMAC's two AXI manager
ports share a latency-configurable memory system through a fair arbiter
(Fig 3); we measure *steady-state* bus utilization (useful payload beats /
cycles at the backend manager interface) and the Table-IV latency probes.

Memory model
------------
* 64-bit data bus (8 B/beat), matching the CVA6 target system.
* One-way request latency ``L`` cycles; responses stream 1 beat/cycle on a
  shared return bus, FCFS in issue order (the fair RR arbiter's long-run
  behaviour).
* A fetch issued at ``t`` with ``b`` beats occupies the return bus during
  ``[max(t + 2L + PIPE, bus_free), +b)`` — request path L, response path L,
  plus ``PIPE`` = 2 fixed pipeline stages. This reproduces Table IV exactly
  for our DMAC: descriptor round trip ``rf-rb = 2L + 2 + 4 beats = 2L + 6``
  -> 8 / 32 / 206 cycles at L = 1 / 13 / 100.

Our frontend (§II-A/C)
----------------------
* Descriptor fetch = 4 beats (32 B @ 64-bit). The ``next`` field occupies
  bytes 8..16, i.e. it arrives with response *beat 2*, so a serialized
  next-fetch can issue two beats before the descriptor completes.
* Without prefetching, the next in-chain fetch waits for the ``next`` field —
  the serialization the paper attacks (period ``2L + 4`` at 64-bit).
* With ``prefetch`` = S, up to S speculative fetches at sequential addresses
  are outstanding; hits pipeline the descriptor stream, a miss re-issues from
  the true address in the same cycle ``next`` arrives (zero added latency,
  §II-C) while already-issued speculative fetches still burn return-bus
  beats — the paper's "minimal additional contention".
* ``in_flight`` = D caps descriptors fetched-but-not-retired.

LogiCORE model (behavioural, calibrated to the paper's measurements)
--------------------------------------------------------------------
32-bit descriptor port -> 8 word-beats per (partial, 416-bit) descriptor
read + 12 cycles descriptor processing (Table IV rf-rb = 2L + 22:
we produce 24/48/222 vs published 22/48/222) + 6 cycles launch/status
overhead, with descriptor handling serialized against transfer launch and a
single outstanding payload burst. This lands the published 2.5x utilization
gap at 64 B in ideal memory exactly; remaining headline ratios come out
within ~15 % (EXPERIMENTS.md reports measured vs published side by side).
"""
from __future__ import annotations

import dataclasses
import numbers
import warnings
from collections import deque
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

if TYPE_CHECKING:  # layering: core never imports mmu at module load
    from repro_torch.mmu.iotlb import IOTLBParams

from .speculation import (
    DEFAULT_DEPTH,
    DEPTH_WINDOW,
    AdaptiveDepth,
    FixedDepth,
    PolicyLike,
    as_policy,
)

BUS_BYTES = 8          # 64-bit data bus
PIPE = 2               # fixed request+response pipeline stages
DESC_BYTES = 32        # our 256-bit descriptor
OURS_DESC_BEATS = DESC_BYTES // BUS_BYTES   # 4 beats
NEXT_FIELD_BEAT = 2    # `next` (bytes 8..16) arrives with beat 2 of 4
LC_DESC_BEATS = 8      # LogiCORE reads 8x32-bit words over its 32-bit port
LC_PROC = 10           # LogiCORE descriptor processing (fits Table IV rf-rb +-2)
LC_LAUNCH = 6          # LogiCORE launch/status overhead per transfer
OURS_I_RF = 3          # Table IV: CPU CSR write -> first read request
LC_I_RF = 10
R_W = 1                # read->write latency inside the backend (both DMACs)


def ideal_utilization(n_bytes: int) -> float:
    """Eq. (1): every n-byte payload costs one 32 B descriptor of bus traffic."""
    return n_bytes / (n_bytes + DESC_BYTES)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Compile-time parameters (paper Table I).

    ``prefetch`` names the frontend's speculation *policy*: either the
    legacy integer slot count (coerced to
    :class:`repro_torch.core.speculation.FixedDepth`, bit-for-bit identical) or
    any :class:`repro_torch.core.speculation.SpeculationPolicy`. The simulator
    instantiates a fresh controller per run and — for adaptive policies —
    re-evaluates the depth every
    :data:`repro_torch.core.speculation.DEPTH_WINDOW` committed descriptors from
    its *own* measured hit rate (the frontend is the measurer; the policy
    is the decider).
    """

    name: str
    in_flight: int = 4
    prefetch: PolicyLike = FixedDepth(0)  # speculation policy (depth API)
    logicore: bool = False     # behavioural LogiCORE IP DMA model
    translated: bool = False   # chain pre-lowered by the translation cache
    # MMU-aware mode (DESIGN.md §11): when set, payload launches must
    # translate their page through an engine-side IOTLB — walk stalls on
    # misses, translation prefetches riding the speculative descriptor
    # stream. ``None`` (default) is bit-for-bit the pre-MMU simulator.
    iotlb: Optional["IOTLBParams"] = None

    def __post_init__(self):
        # The speculation-policy layer is the single depth API: a bare int
        # still works for one release (coerced through FixedDepth, which
        # as_policy makes bit-for-bit identical) but warns.
        if isinstance(self.prefetch, numbers.Integral):
            warnings.warn(
                "SimConfig.prefetch as a bare int is deprecated; pass a "
                "speculation policy (repro_torch.core.speculation.FixedDepth(n))."
                " The int form is removed one release after 0.4.",
                DeprecationWarning, stacklevel=3)
            object.__setattr__(self, "prefetch",
                               FixedDepth(int(self.prefetch)))

    @staticmethod
    def base() -> "SimConfig":
        return SimConfig("base", in_flight=4, prefetch=FixedDepth(0))

    @staticmethod
    def translated_frontend() -> "SimConfig":
        """Frontend driven by a cached lowered chain (DESIGN.md §7).

        The compiled artifact already knows every descriptor address, so
        fetches issue back-to-back (1/cycle) with no ``next``-field wait —
        the software analogue of removing §II-A's serialization entirely.
        Payloads still pay full descriptor traffic and bus contention.
        """
        return SimConfig("translated", in_flight=4, prefetch=FixedDepth(0),
                         translated=True)

    @staticmethod
    def speculation() -> "SimConfig":
        return SimConfig("speculation", in_flight=4,
                         prefetch=FixedDepth(DEFAULT_DEPTH))

    @staticmethod
    def scaled() -> "SimConfig":
        return SimConfig("scaled", in_flight=24, prefetch=FixedDepth(24))

    @staticmethod
    def adaptive(policy: Optional[AdaptiveDepth] = None) -> "SimConfig":
        p = policy or AdaptiveDepth()
        return SimConfig("adaptive", in_flight=p.max_depth, prefetch=p)

    @staticmethod
    def fixed(depth: int = DEFAULT_DEPTH) -> "SimConfig":
        """Fixed-depth frontend via the policy layer (== speculation())."""
        return SimConfig(f"fixed{depth}", in_flight=4,
                         prefetch=FixedDepth(depth))

    @staticmethod
    def logicore_ip() -> "SimConfig":
        return SimConfig("LogiCORE", in_flight=4, prefetch=FixedDepth(0),
                         logicore=True)


# Memory-system configurations of §III-A.
MEMORY_CONFIGS: Dict[str, int] = {
    "ideal": 1,        # SRAM-like
    "ddr3": 13,        # Genesys-2 DDR3
    "ultra_deep": 100, # large NoC
}


@dataclasses.dataclass
class SimResult:
    config: str
    mem_latency: int
    transfer_bytes: int
    hit_rate: float
    utilization: float
    ideal: float
    cycles: int
    payload_beats: int
    desc_beats: int
    wasted_beats: int      # discarded speculative descriptor traffic
    rf_rb: float           # descriptor-fetch round trip (Table IV)
    i_rf: int
    r_w: int
    # Speculation-policy trajectory (constant for FixedDepth frontends).
    final_depth: int = 0
    mean_depth: float = 0.0
    # IOTLB metrics (DESIGN.md §11); all zero when SimConfig.iotlb is None.
    tlb_hits: int = 0
    tlb_misses: int = 0
    tlb_hit_rate: float = 0.0
    walk_stall_cycles: float = 0.0


class _Bus:
    """Shared return-data bus: FCFS beat scheduler (grant in issue order)."""

    def __init__(self, latency: int):
        self.lat = latency
        self.free = 0.0

    def fetch(self, t_issue: float, beats: int) -> tuple[float, float]:
        """Schedule a fetch; returns (first_beat_start, last_beat_end)."""
        start = max(t_issue + 2 * self.lat + PIPE, self.free)
        self.free = start + beats
        return start, self.free


def _simulate_ours(
    cfg: SimConfig,
    mem_latency: int,
    transfer_bytes: int,
    num_transfers: int,
    hit_rate: float,
    seed: int,
    payload_ratio: float = 1.0,
) -> SimResult:
    rng = np.random.default_rng(seed)
    bus = _Bus(mem_latency)
    payload_beats_each = max(1, int(transfer_bytes * payload_ratio) // BUS_BYTES)
    spec = as_policy(cfg.prefetch).make_controller()
    cur_depth = spec.depth
    spec_on = spec.enabled
    depth_sum, depth_n = cur_depth, 1    # trajectory stats (per window)
    window_hits = window_n = 0           # the frontend's own measurement

    # MMU-aware mode (DESIGN.md §11): payload launches translate their
    # page through the IOTLB; translation prefetches ride the speculative
    # descriptor stream under their own lookahead policy. One page per
    # descriptor (the paged-KV shape: page == transfer unit).
    tlb = tlb_ctrl = None
    tlb_depth = 0
    tlb_window_h = tlb_window_n = 0
    pages = None
    far_page = 2 * num_transfers         # spec-miss jump target stream
    pred_next_page = 1                   # chain-lookahead prediction anchor
    if cfg.iotlb is not None:
        from repro_torch.mmu.iotlb import IOTLB
        tlb = IOTLB(cfg.iotlb, mem_latency=mem_latency)
        tlb_ctrl = as_policy(cfg.iotlb.prefetch).make_controller()
        tlb_depth = tlb_ctrl.depth
        pages = np.zeros(num_transfers, np.int64)

    next_known = np.zeros(num_transfers)   # cycle `next` field arrives
    desc_end = np.zeros(num_transfers)     # cycle descriptor fully arrived
    payload_end = np.zeros(num_transfers)
    desc_beats_total = 0
    wasted_beats = 0
    rf_rb_first = None

    # Outstanding speculative fetches for positions > last committed:
    # deque of (pos, issue, next_known, data_end).
    spec_queue: deque = deque()
    last_spec_issue = 0.0
    last_spec_pos = 0

    def issue_desc(pos: int, t_issue: float):
        nonlocal desc_beats_total, rf_rb_first
        start, end = bus.fetch(t_issue, OURS_DESC_BEATS)
        desc_beats_total += OURS_DESC_BEATS
        if rf_rb_first is None:
            rf_rb_first = end - t_issue
        return start + NEXT_FIELD_BEAT, end

    def top_up_spec(now: float, committed: int):
        """Issue speculative fetches at sequential addresses.

        Speculation keys off the *last issued* address (§II-C: requests go
        out "with sequential addresses" as soon as a slot is available), so
        the issue time follows the previous issue, not data arrival.
        """
        nonlocal last_spec_issue, last_spec_pos, pred_next_page
        while (len(spec_queue) < cur_depth
               and last_spec_pos + 1 < num_transfers
               and (last_spec_pos + 1) - committed <= cfg.in_flight):
            pos = last_spec_pos + 1
            t_issue = max(last_spec_issue + 1, now)
            if tlb is not None and len(spec_queue) < tlb_depth:
                # Chain-lookahead translation prefetch (arXiv 1808.09751):
                # the speculative fetch's predicted sequential page starts
                # its walk the cycle the fetch issues.
                tlb.prefetch(pred_next_page, t_issue)
            pred_next_page += 1
            nk, end = issue_desc(pos, t_issue)
            spec_queue.append((pos, t_issue, nk, end))
            last_spec_issue, last_spec_pos = t_issue, pos

    def launch_payload(idx: int):
        """Payload launch for committed descriptor ``idx``: in MMU mode
        the launch first translates its page; a miss stalls the walk."""
        nonlocal tlb_window_h, tlb_window_n, tlb_depth
        t_launch = desc_end[idx] + 1
        if tlb is not None:
            before = tlb.hits
            t_launch += tlb.access(int(pages[idx]), t_launch)
            tlb_window_n += 1
            tlb_window_h += int(tlb.hits > before)
            if tlb_window_n >= DEPTH_WINDOW:
                tlb_depth = tlb_ctrl.observe(tlb_window_h / tlb_window_n)
                tlb_window_h = tlb_window_n = 0
        _, payload_end[idx] = bus.fetch(t_launch, payload_beats_each)

    # Descriptor 0: its address came from the CSR write (always known) —
    # in MMU mode its translation walk starts just as early.
    if tlb is not None and tlb_depth > 0:
        tlb.prefetch(0, 0.0)
    nk, end = issue_desc(0, 0.0)
    next_known[0], desc_end[0] = nk, end
    if spec_on:
        last_spec_issue, last_spec_pos = 0.0, 0
        top_up_spec(1.0, committed=1)

    for k in range(1, num_transfers):
        # NOTE on call order: the shared bus grants FCFS by issue time, and
        # bursts are granted in *call* order here, so within an iteration we
        # schedule in nondecreasing issue order: (re-)fetch of descriptor k
        # (issue = next_known[k-1]) and its speculative successors
        # (issue+1, ...) strictly precede the payload launch for k-1
        # (issue = desc_end[k-1] + 1 = next_known[k-1] + 3).
        speculated = spec_on and bool(spec_queue)
        hit = bool(speculated and rng.random() < hit_rate)
        if speculated:
            # The frontend measures its own §II-C hit rate: one observation
            # per chain boundary where speculation was actually in flight.
            window_n += 1
            window_hits += int(hit)
        if hit:
            pos, t_issue, nk, end = spec_queue.popleft()
            assert pos == k
            if pages is not None:
                pages[k] = pages[k - 1] + 1   # sequential: prediction held
            next_known[k] = max(nk, next_known[k - 1])
            desc_end[k] = max(end, next_known[k - 1])
            launch_payload(k - 1)
            # Commit frees a speculation slot.
            top_up_spec(next_known[k], committed=k + 1)
        else:
            if speculated:
                # Mispredict: discard outstanding speculative data (its bus
                # beats were already consumed = pure contention), re-issue
                # the true fetch in the same cycle `next` arrived.
                wasted_beats += OURS_DESC_BEATS * len(spec_queue)
                spec_queue.clear()
            if pages is not None:
                if speculated:
                    # The chain jumped: the true target is a far page the
                    # lookahead never walked (prefetched predictions were
                    # wasted walker work, like wasted descriptor beats).
                    pages[k] = far_page
                    far_page += num_transfers
                else:
                    pages[k] = pages[k - 1] + 1
                pred_next_page = pages[k] + 1
            t_issue = next_known[k - 1]
            nk, end = issue_desc(k, t_issue)
            next_known[k], desc_end[k] = nk, end
            if spec_on:
                # Speculation restarts from the re-fetched address.
                last_spec_issue, last_spec_pos = t_issue, k
                top_up_spec(t_issue + 1, committed=k)
            launch_payload(k - 1)
        if window_n >= DEPTH_WINDOW:
            # Chain boundary: the measured window feeds the policy. A new
            # depth only affects future top-ups — fetches already
            # outstanding drain under the depth that issued them.
            cur_depth = spec.observe(window_hits / window_n)
            depth_sum += cur_depth
            depth_n += 1
            window_hits = window_n = 0

    launch_payload(num_transfers - 1)

    lo, hi = num_transfers // 4, 3 * num_transfers // 4
    window_cycles = payload_end[hi] - payload_end[lo]
    util = (hi - lo) * payload_beats_each / max(window_cycles, 1e-9)

    return SimResult(
        config=cfg.name, mem_latency=mem_latency,
        transfer_bytes=transfer_bytes, hit_rate=hit_rate,
        utilization=float(min(util, ideal_utilization(transfer_bytes))),
        ideal=ideal_utilization(transfer_bytes),
        cycles=int(payload_end[-1]),
        payload_beats=num_transfers * payload_beats_each,
        desc_beats=desc_beats_total, wasted_beats=int(wasted_beats),
        # Table IV probes single-transfer latency: the uncongested first fetch.
        rf_rb=float(rf_rb_first), i_rf=OURS_I_RF, r_w=R_W,
        final_depth=cur_depth, mean_depth=depth_sum / depth_n,
        tlb_hits=tlb.hits if tlb is not None else 0,
        tlb_misses=tlb.misses if tlb is not None else 0,
        tlb_hit_rate=tlb.hit_rate if tlb is not None else 0.0,
        walk_stall_cycles=float(tlb.walk_stall_cycles)
        if tlb is not None else 0.0,
    )


def _simulate_translated(
    cfg: SimConfig, mem_latency: int, transfer_bytes: int, num_transfers: int,
    payload_ratio: float = 1.0,
) -> SimResult:
    """Launch model for a cached lowered chain.

    Every descriptor address is embedded in the compiled artifact, so the
    frontend issues fetches back-to-back at 1/cycle instead of waiting
    ``2L + NEXT_FIELD_BEAT`` for each ``next`` pointer; each payload
    launches one cycle after its descriptor data lands. All traffic still
    shares the FCFS return bus (grant in *issue-time* order, via a heap —
    descriptor k+1's early issue rightly outranks payload k's later one),
    so the steady-state floor is the pure bus occupancy of
    ``4 + payload`` beats per transfer. Deterministic: no speculation, no
    randomness.
    """
    import heapq

    bus = _Bus(mem_latency)
    payload_beats_each = max(1, int(transfer_bytes * payload_ratio) // BUS_BYTES)
    desc_end = np.zeros(num_transfers)
    payload_end = np.zeros(num_transfers)
    rf_rb_first = None

    events: List[Tuple[float, int, int, int]] = []  # (issue, seq, kind, idx)
    seq = 0
    for k in range(num_transfers):       # kind 0 = descriptor fetch
        heapq.heappush(events, (float(k), seq, 0, k))
        seq += 1
    while events:
        t_issue, _, kind, idx = heapq.heappop(events)
        if kind == 0:
            _, end = bus.fetch(t_issue, OURS_DESC_BEATS)
            desc_end[idx] = end
            if rf_rb_first is None:
                rf_rb_first = end - t_issue
            heapq.heappush(events, (end + 1, seq, 1, idx))
            seq += 1
        else:
            _, payload_end[idx] = bus.fetch(t_issue, payload_beats_each)

    lo, hi = num_transfers // 4, 3 * num_transfers // 4
    window_cycles = payload_end[hi] - payload_end[lo]
    util = (hi - lo) * payload_beats_each / max(window_cycles, 1e-9)
    return SimResult(
        config=cfg.name, mem_latency=mem_latency,
        transfer_bytes=transfer_bytes, hit_rate=1.0,
        utilization=float(min(util, ideal_utilization(transfer_bytes))),
        ideal=ideal_utilization(transfer_bytes),
        cycles=int(payload_end[-1]),
        payload_beats=num_transfers * payload_beats_each,
        desc_beats=num_transfers * OURS_DESC_BEATS, wasted_beats=0,
        rf_rb=float(rf_rb_first), i_rf=OURS_I_RF, r_w=R_W,
    )


def _simulate_logicore(
    cfg: SimConfig, mem_latency: int, transfer_bytes: int, num_transfers: int,
    seed: int, payload_ratio: float = 1.0,
) -> SimResult:
    """Serialized descriptor engine; see module docstring for calibration."""
    bus = _Bus(mem_latency)
    payload_beats_each = max(1, int(transfer_bytes * payload_ratio) // BUS_BYTES)
    rf_rb = 2 * mem_latency + PIPE + LC_DESC_BEATS + LC_PROC
    payload_ends = np.zeros(num_transfers)
    desc_beats_total = 0
    t = 0.0
    prev_payload_end = 0.0
    for i in range(num_transfers):
        _, fetch_end = bus.fetch(t, LC_DESC_BEATS)
        desc_beats_total += LC_DESC_BEATS
        proc_done = fetch_end + LC_PROC
        # Single outstanding payload burst; next descriptor fetch overlaps the
        # payload data return but not processing/launch.
        payload_issue = max(proc_done + 1, prev_payload_end)
        _, prev_payload_end = bus.fetch(payload_issue, payload_beats_each)
        payload_ends[i] = prev_payload_end
        t = proc_done + LC_LAUNCH
    lo, hi = num_transfers // 4, 3 * num_transfers // 4
    window = payload_ends[hi] - payload_ends[lo]
    util = (hi - lo) * payload_beats_each / max(window, 1e-9)
    return SimResult(
        config=cfg.name, mem_latency=mem_latency,
        transfer_bytes=transfer_bytes, hit_rate=1.0,
        utilization=float(util), ideal=ideal_utilization(transfer_bytes),
        cycles=int(payload_ends[-1]),
        payload_beats=num_transfers * payload_beats_each,
        desc_beats=desc_beats_total, wasted_beats=0,
        rf_rb=float(rf_rb), i_rf=LC_I_RF, r_w=R_W,
    )


def simulate(
    cfg: SimConfig,
    mem_latency: int,
    transfer_bytes: int,
    *,
    num_transfers: int = 2000,
    hit_rate: float = 1.0,
    seed: int = 0,
    payload_ratio: float = 1.0,
) -> SimResult:
    """Steady-state bus utilization of one (config, memory, size) point.

    ``payload_ratio`` models an in-flight transform in the datapath: the
    frontend still walks ``transfer_bytes`` of logical payload per
    descriptor, but only ``transfer_bytes * payload_ratio`` bytes cross
    the return bus (e.g. ~0.254 for EF-int8 KV quantization). Descriptor
    traffic is unchanged — transforms act on payload beats only.
    """
    if transfer_bytes % BUS_BYTES:
        raise ValueError("paper evaluates bus-aligned transfer sizes")
    if not 0.0 < payload_ratio <= 1.0:
        raise ValueError("payload_ratio must be in (0, 1]")
    if cfg.logicore:
        return _simulate_logicore(cfg, mem_latency, transfer_bytes,
                                  num_transfers, seed, payload_ratio)
    if cfg.translated:
        return _simulate_translated(cfg, mem_latency, transfer_bytes,
                                    num_transfers, payload_ratio)
    return _simulate_ours(cfg, mem_latency, transfer_bytes, num_transfers,
                          hit_rate, seed, payload_ratio)


def utilization_sweep(
    cfg: SimConfig,
    mem_latency: int,
    sizes: Optional[List[int]] = None,
    hit_rate: float = 1.0,
) -> List[SimResult]:
    """One curve of Fig 4 (or Fig 5 at a given hit rate)."""
    sizes = sizes or [32, 64, 128, 256, 512, 1024, 2048, 4096]
    return [simulate(cfg, mem_latency, s, hit_rate=hit_rate) for s in sizes]


# ---------------------------------------------------------------------------
# Multi-channel mode (runtime layer): N frontends sharing the bus
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChannelSimResult:
    channel: str
    weight: int
    transfers: int
    payload_beats: int
    desc_beats: int
    utilization: float     # this channel's payload beats / shared-bus cycles
    mean_launch_gap: float # cycles between consecutive launches on channel
    shard: int = 0         # frontend group (0 for the unsharded model)


@dataclasses.dataclass
class ShardedBusResult:
    """Cross-shard contention summary of a sharded multichannel run.

    The per-shard local buses model a shard's own memory system; the
    shared interconnect carries cross-shard page-migration payloads plus
    one §II-D writeback beat per hop (the control-channel completion
    riding along). ``migration_cycles_mean`` is the added cycles a
    migrated transfer spends between finishing on its local bus and its
    hop (payload + writeback) clearing the interconnect.
    """

    num_shards: int
    per_shard_utilization: List[float]
    mean_shard_utilization: float
    cross_transfers: int
    cross_fraction: float
    interconnect_latency: int
    migration_cycles_mean: float
    interconnect_busy_beats: int
    # Contended mode (per-directed-link buses) additions; the shared-bus
    # default leaves num_links at 0 and keeps its original numbers.
    interconnect_mode: str = "shared"
    migration_cycles_p99: float = 0.0
    num_links: int = 0
    link_busy_beats_max: int = 0


@dataclasses.dataclass
class MultiChannelResult:
    mem_latency: int
    transfer_bytes: int
    aggregate_utilization: float
    ideal: float
    cycles: int
    channels: List[ChannelSimResult]
    sharded: Optional[ShardedBusResult] = None


def _multichannel_pass(
    num_channels: int,
    bus: _Bus,
    payload_beats_each: int,
    num_transfers: int,
    weights: List[int],
):
    """One group of serialized frontends contending on one shared bus.

    Returns per-channel launch times, payload end times, and beat counts;
    callers build steady-state windows (and, for sharded runs, feed the
    payload ends into the interconnect phase).
    """
    # Backlogged-channel model: offered load tracks weight, so every channel
    # stays busy across the whole measurement window and the reported
    # shares reflect arbitration, not early completion.
    remaining = np.asarray([num_transfers * w for w in weights])
    launches: List[List[float]] = [[] for _ in range(num_channels)]
    ends: List[List[float]] = [[] for _ in range(num_channels)]
    desc_beats = np.zeros(num_channels, np.int64)
    payload_beats = np.zeros(num_channels, np.int64)
    credit = np.zeros(num_channels)
    last_end = 0.0

    # Event-driven: (issue_time, seq, channel, kind). The bus is granted in
    # issue order; requests already issued when the bus frees contend, and
    # the smooth-WRR credits pick the winner (equal weights == fair RR).
    import heapq
    pend: List[tuple] = []
    seq = 0
    for c in range(num_channels):
        heapq.heappush(pend, (0.0, seq, c, "desc")); seq += 1

    while pend:
        horizon = max(bus.free, pend[0][0])
        batch = []
        while pend and pend[0][0] <= horizon:
            batch.append(heapq.heappop(pend))
        credit += weights
        batch.sort(key=lambda e: (-credit[e[2]], e[0], e[1]))
        t_issue, sq, c, kind = batch[0]
        for e in batch[1:]:
            heapq.heappush(pend, e)
        credit[c] -= sum(weights)

        if kind == "desc":
            start, end = bus.fetch(t_issue, OURS_DESC_BEATS)
            desc_beats[c] += OURS_DESC_BEATS
            heapq.heappush(pend, (end + 1, seq, c, "payload")); seq += 1
            remaining[c] -= 1
            if remaining[c] > 0:
                # §II-A serialization: the next in-chain fetch may only
                # issue once this descriptor's `next` field has arrived.
                heapq.heappush(
                    pend, (start + NEXT_FIELD_BEAT, seq, c, "desc")); seq += 1
        else:
            _, p_end = bus.fetch(t_issue, payload_beats_each)
            payload_beats[c] += payload_beats_each
            launches[c].append(t_issue)
            ends[c].append(p_end)
            last_end = max(last_end, p_end)

    return launches, ends, desc_beats, payload_beats, last_end


def _channel_results(
    launches: List[List[float]],
    desc_beats: np.ndarray,
    payload_beats: np.ndarray,
    payload_beats_each: int,
    num_transfers: int,
    weights: List[int],
    shard_of: List[int],
) -> Tuple[List[ChannelSimResult], float]:
    """Per-channel utilization over the middle half of the global launches."""
    all_launch = np.sort(np.concatenate([np.asarray(l) for l in launches]))
    lo, hi = all_launch[len(all_launch) // 4], all_launch[3 * len(all_launch) // 4]
    window = max(hi - lo, 1e-9)
    chans = []
    for c in range(len(launches)):
        l = np.asarray(launches[c])
        in_win = ((l >= lo) & (l < hi)).sum()
        gaps = np.diff(l)
        chans.append(ChannelSimResult(
            channel=f"ch{c}", weight=weights[c],
            transfers=num_transfers * weights[c],
            payload_beats=int(payload_beats[c]),
            desc_beats=int(desc_beats[c]),
            utilization=float(in_win * payload_beats_each / window),
            mean_launch_gap=float(gaps.mean()) if len(gaps) else 0.0,
            shard=shard_of[c],
        ))
    return chans, window


def _trace_channels(tracer, track_prefix: str, launches, ends,
                    shard_of: List[int]) -> None:
    """Emit one cycle-clock payload span per simulated transfer.

    Simulated cycles are their own clock domain (``clock="cycle"``): the
    exporter renders them on separate tracks at 1 cycle == 1 µs, so a
    sweep cell's bus behaviour loads in Perfetto next to (not interleaved
    with) wall-clock runtime spans (DESIGN.md §8).
    """
    for c, (l, e) in enumerate(zip(launches, ends)):
        track = f"{track_prefix}shard{shard_of[c]}/ch{c}" \
            if len(set(shard_of)) > 1 else f"{track_prefix}ch{c}"
        for i, (t0, t1) in enumerate(zip(l, e)):
            tracer.complete("payload", track, float(t0), float(t1 - t0),
                            clock="cycle", transfer=i)


def simulate_multichannel(
    num_channels: int,
    mem_latency: int,
    transfer_bytes: int,
    *,
    num_transfers: int = 500,
    weights: Optional[List[int]] = None,
    arbitration: str = "weighted_rr",
    shard_of: Optional[List[int]] = None,
    cross_fraction: float = 0.0,
    interconnect_latency: Optional[int] = None,
    interconnect_mode: str = "shared",
    seed: int = 0,
    tracer=None,
    trace_track_prefix: str = "sim/",
) -> MultiChannelResult:
    """N serialized frontends (base config) interleaved on shared buses.

    Each channel alone suffers the §II-A descriptor serialization (its next
    fetch waits for the previous ``next`` field); the multi-channel runtime
    hides that latency with *inter-channel* parallelism: while channel A
    waits on its round trip, B..N own the bus. The arbiter is the smooth
    weighted round-robin used by :class:`repro_torch.runtime.WeightedArbiter`
    (all-equal weights == fair RR, the paper's §III-A arbiter).

    **Per-shard frontend grouping** (sharded serving, DESIGN.md §6): with
    ``shard_of`` (one group id per channel), each shard's channels contend
    on their *own* local bus, and a deterministic ``cross_fraction`` of
    every shard's transfers are cross-shard migrations: after finishing on
    the local bus they traverse one shared interconnect
    (``interconnect_latency``, default ``4 * mem_latency`` — the slow
    fabric between shards) carrying the payload plus one per-hop §II-D
    writeback beat. ``shard_of=None`` is the original single-bus model,
    bit-for-bit.

    ``interconnect_mode`` picks the fabric model: ``"shared"`` (default,
    bit-for-bit the original) serializes every hop through one bus;
    ``"contended"`` gives each *directed* (src, dst) shard pair its own
    link — hops only queue behind traffic on their own link, each hop's
    destination drawn deterministically from the same per-channel rng
    stream — and reports the per-hop stall tail
    (``migration_cycles_p99``) the async fabric is gated against.
    """
    if interconnect_mode not in ("shared", "contended"):
        raise ValueError(
            f"interconnect_mode must be 'shared' or 'contended', "
            f"got {interconnect_mode!r}")
    if transfer_bytes % BUS_BYTES:
        raise ValueError("paper evaluates bus-aligned transfer sizes")
    if num_channels < 1:
        raise ValueError("need >= 1 channel")
    weights = list(weights) if weights else [1] * num_channels
    if len(weights) != num_channels:
        raise ValueError("one weight per channel")
    del arbitration  # single policy today; named for config clarity
    payload_beats_each = max(1, transfer_bytes // BUS_BYTES)
    ideal = ideal_utilization(transfer_bytes)

    if shard_of is None:
        if cross_fraction:
            raise ValueError("cross_fraction requires shard_of grouping")
        bus = _Bus(mem_latency)
        launches, ends, desc_beats, payload_beats, last_end = \
            _multichannel_pass(num_channels, bus, payload_beats_each,
                               num_transfers, weights)
        if tracer is not None:
            _trace_channels(tracer, trace_track_prefix, launches, ends,
                            [0] * num_channels)
        chans, _ = _channel_results(
            launches, desc_beats, payload_beats, payload_beats_each,
            num_transfers, weights, [0] * num_channels)
        agg = float(sum(ch.utilization for ch in chans))
        return MultiChannelResult(
            mem_latency=mem_latency, transfer_bytes=transfer_bytes,
            aggregate_utilization=min(agg, ideal), ideal=ideal,
            cycles=int(last_end), channels=chans)

    # -- sharded grouping ---------------------------------------------------
    if len(shard_of) != num_channels:
        raise ValueError("one shard id per channel")
    if not 0.0 <= cross_fraction <= 1.0:
        raise ValueError("cross_fraction must be in [0, 1]")
    shards = sorted(set(shard_of))
    if interconnect_latency is None:
        interconnect_latency = 4 * mem_latency

    launches = [None] * num_channels
    ends = [None] * num_channels
    desc_beats = np.zeros(num_channels, np.int64)
    payload_beats = np.zeros(num_channels, np.int64)
    last_end = 0.0
    for s in shards:
        members = [c for c in range(num_channels) if shard_of[c] == s]
        bus = _Bus(mem_latency)
        l, e, db, pb, le = _multichannel_pass(
            len(members), bus, payload_beats_each, num_transfers,
            [weights[c] for c in members])
        for k, c in enumerate(members):
            launches[c], ends[c] = l[k], e[k]
            desc_beats[c], payload_beats[c] = db[k], pb[k]
        last_end = max(last_end, le)

    if tracer is not None:
        _trace_channels(tracer, trace_track_prefix, launches, ends,
                        list(shard_of))

    chans, window = _channel_results(
        launches, desc_beats, payload_beats, payload_beats_each,
        num_transfers, weights, list(shard_of))
    per_shard = [
        float(sum(ch.utilization for ch in chans if ch.shard == s))
        for s in shards]

    # Interconnect phase: a deterministic subset of each channel's
    # transfers migrate to a remote shard. Hops are granted FCFS in
    # local-completion order; each occupies the interconnect for the
    # payload plus the per-hop completion writeback beat.
    hop_beats = payload_beats_each + 1   # payload + §II-D writeback beat
    added: List[float] = []
    num_links = 0
    link_busy_max = 0
    if interconnect_mode == "shared":
        hop_times: List[float] = []
        if len(shards) > 1 and cross_fraction > 0.0:
            for c in range(num_channels):
                rng = np.random.default_rng([seed, shard_of[c], c])
                e = np.asarray(ends[c])
                hop_times.extend(
                    e[rng.random(len(e)) < cross_fraction].tolist())
        hop_times.sort()
        ibus = _Bus(interconnect_latency)
        for t in hop_times:
            _, hop_end = ibus.fetch(t + 1, hop_beats)
            added.append(hop_end - t)
            last_end = max(last_end, hop_end)
            if tracer is not None:
                tracer.complete("migration.hop",
                                f"{trace_track_prefix}interconnect",
                                float(t), float(hop_end - t), clock="cycle",
                                beats=hop_beats)
        n_hops = len(hop_times)
    else:
        # Contended fabric: one bus per *directed* (src, dst) pair, so a
        # hop only stalls behind earlier traffic on its own link. The
        # selection draws are identical to shared mode (same rng
        # prefix); the destination draw comes after, so flipping the
        # mode never changes *which* transfers migrate.
        hops: List[Tuple[float, int, int]] = []
        if len(shards) > 1 and cross_fraction > 0.0:
            for c in range(num_channels):
                rng = np.random.default_rng([seed, shard_of[c], c])
                e = np.asarray(ends[c])
                sel = rng.random(len(e)) < cross_fraction
                remotes = [s for s in shards if s != shard_of[c]]
                dst_idx = rng.integers(0, len(remotes), int(sel.sum()))
                hops.extend(
                    (float(t), shard_of[c], remotes[int(d)])
                    for t, d in zip(e[sel], dst_idx))
        hops.sort()
        links: Dict[Tuple[int, int], _Bus] = {}
        busy: Dict[Tuple[int, int], int] = {}
        for t, s, d in hops:
            ln = links.get((s, d))
            if ln is None:
                ln = links[(s, d)] = _Bus(interconnect_latency)
            _, hop_end = ln.fetch(t + 1, hop_beats)
            busy[(s, d)] = busy.get((s, d), 0) + hop_beats
            added.append(hop_end - t)
            last_end = max(last_end, hop_end)
            if tracer is not None:
                tracer.complete(
                    "migration.hop",
                    f"{trace_track_prefix}interconnect/link{s}-{d}",
                    float(t), float(hop_end - t), clock="cycle",
                    beats=hop_beats, src=s, dst=d)
        n_hops = len(hops)
        num_links = len(links)
        link_busy_max = max(busy.values(), default=0)
    sharded = ShardedBusResult(
        num_shards=len(shards),
        per_shard_utilization=per_shard,
        mean_shard_utilization=float(np.mean(per_shard)),
        cross_transfers=n_hops,
        cross_fraction=cross_fraction,
        interconnect_latency=interconnect_latency,
        migration_cycles_mean=float(np.mean(added)) if added else 0.0,
        interconnect_busy_beats=n_hops * hop_beats,
        interconnect_mode=interconnect_mode,
        migration_cycles_p99=float(np.percentile(added, 99))
        if added else 0.0,
        num_links=num_links,
        link_busy_beats_max=link_busy_max,
    )
    agg = float(sum(per_shard))
    return MultiChannelResult(
        mem_latency=mem_latency, transfer_bytes=transfer_bytes,
        # Shard-local buses scale the aggregate past one bus's Eq.-1
        # ideal; cap at the mesh-wide ideal instead (S local buses).
        aggregate_utilization=min(agg, ideal * len(shards)), ideal=ideal,
        cycles=int(last_end), channels=chans, sharded=sharded)


def simulate_sharded(
    num_shards: int,
    channels_per_shard: int,
    mem_latency: int,
    transfer_bytes: int,
    *,
    num_transfers: int = 500,
    cross_fraction: float = 0.0,
    interconnect_latency: Optional[int] = None,
    interconnect_mode: str = "shared",
    seed: int = 0,
    tracer=None,
) -> MultiChannelResult:
    """S shard groups of N frontends each: the sharded runtime's bus model."""
    if num_shards < 1:
        raise ValueError("need >= 1 shard")
    shard_of = [s for s in range(num_shards)
                for _ in range(channels_per_shard)]
    return simulate_multichannel(
        num_shards * channels_per_shard, mem_latency, transfer_bytes,
        num_transfers=num_transfers, shard_of=shard_of,
        cross_fraction=cross_fraction if num_shards > 1 else 0.0,
        interconnect_latency=interconnect_latency,
        interconnect_mode=interconnect_mode, seed=seed,
        tracer=tracer)


def table_iv(mem_latencies=(1, 13, 100)) -> Dict[str, Dict]:
    """Latency probes (Table IV): i-rf, rf-rb per memory latency, r-w."""
    ours, lc = {}, {}
    for L in mem_latencies:
        r_o = simulate(SimConfig.scaled(), L, 64, num_transfers=64)
        r_l = simulate(SimConfig.logicore_ip(), L, 64, num_transfers=64)
        ours[L], lc[L] = r_o.rf_rb, r_l.rf_rb
    return {
        "ours": {"i_rf": OURS_I_RF, "rf_rb": ours, "r_w": R_W},
        "logicore": {"i_rf": LC_I_RF, "rf_rb": lc, "r_w": R_W},
        "paper": {
            "ours": {"i_rf": 3, "rf_rb": {1: 8, 13: 32, 100: 206}, "r_w": 1},
            "logicore": {"i_rf": 10, "rf_rb": {1: 22, 13: 48, 100: 222}, "r_w": 1},
        },
    }
