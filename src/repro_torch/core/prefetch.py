"""Speculative-prefetch policy layer (§II-C) — planning and modelling.

The hardware speculates sequential descriptor addresses. This module hosts
(1) the analytical utilization model used to sanity-check the cycle
simulator, and (2) the *software speculation contract*: given an allocator
that owns descriptor placement, sequential layout makes speculation perfect
(see :func:`repro_torch.core.chain.plan_sequential_layout`); given an external
layout, :func:`estimate_hit_rate` predicts what the prefetcher will achieve.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .descriptor import DESCRIPTOR_BYTES
from .simulator import BUS_BYTES, PIPE, OURS_DESC_BEATS, ideal_utilization
from .speculation import DEFAULT_DEPTH, PolicyLike, static_depth


@dataclasses.dataclass(frozen=True)
class AnalyticalPoint:
    utilization: float
    bound: str  # "bus" | "descriptor-serialization" | "slot-rate"


def analytical_utilization(
    transfer_bytes: int,
    mem_latency: int,
    *,
    prefetch: PolicyLike = 0,
    in_flight: int = 4,
    hit_rate: float = 1.0,
) -> AnalyticalPoint:
    """Closed-form steady-state utilization (cross-check for the simulator).

    Per transfer the shared bus carries ``4 + n/8`` beats (descriptor +
    payload; Eq. 1). Three candidate period bounds:

    * bus:        ``beats = 4 + n/8`` (+ wasted speculative beats on misses)
    * serialization (no prefetch / miss): descriptor round trip ``2L + 6``
    * slot rate (prefetch on): ``(2L + 6) / min(prefetch, in_flight)``
    """
    # The closed-form model has no feedback path, so a policy contributes
    # its static (initial) depth — the adaptive trajectory lives in the
    # cycle simulator only.
    prefetch = static_depth(prefetch)
    rt = 2 * mem_latency + PIPE + OURS_DESC_BEATS
    payload_beats = transfer_bytes // BUS_BYTES
    bus = OURS_DESC_BEATS + payload_beats
    if prefetch == 0:
        period = max(rt, bus)
        bound = "bus" if bus >= rt else "descriptor-serialization"
    else:
        slots = max(1, min(prefetch, in_flight))
        slot_rate = rt / slots
        miss = 1.0 - hit_rate
        # A miss serializes that boundary and wastes ~E[outstanding] fetches.
        outstanding = min(slots, max(1, round(rt / max(bus, 1))))
        eff_bus = bus + miss * outstanding * OURS_DESC_BEATS
        period = max(hit_rate * slot_rate + miss * rt, eff_bus)
        bound = ("bus" if eff_bus >= hit_rate * slot_rate + miss * rt
                 else "slot-rate" if hit_rate > 0.5 else "descriptor-serialization")
    return AnalyticalPoint(utilization=min(payload_beats / period,
                                           ideal_utilization(transfer_bytes)),
                           bound=bound)


def estimate_hit_rate(descriptor_addrs: np.ndarray) -> float:
    """Hit rate a sequential speculator sees on a chain laid out at ``addrs``.

    ``descriptor_addrs[k]`` is the byte address of the k-th descriptor in
    *chain order*; a hit means addr[k+1] == addr[k] + 32.
    """
    a = np.asarray(descriptor_addrs, np.int64)
    if a.size <= 1:
        return 1.0
    return float(np.mean(a[1:] == a[:-1] + DESCRIPTOR_BYTES))


def speculation_breakeven(mem_latency: int, transfer_bytes: int) -> float:
    """Hit rate above which speculation beats the serialized frontend.

    Speculation never adds latency (§II-C); it only adds contention. The
    breakeven is where wasted descriptor beats outweigh hidden round trips —
    for bus-bound sizes that is h > 0 (always worth it); for
    serialization-bound sizes any h > 0 already helps. Returns 0.0 unless
    the workload is so bus-saturated that waste dominates.
    """
    base = analytical_utilization(transfer_bytes, mem_latency, prefetch=0)
    lo, hi = 0.0, 1.0
    for _ in range(20):
        mid = (lo + hi) / 2
        u = analytical_utilization(transfer_bytes, mem_latency,
                                   prefetch=DEFAULT_DEPTH,
                                   hit_rate=mid).utilization
        if u >= base.utilization:
            hi = mid
        else:
            lo = mid
    return hi
