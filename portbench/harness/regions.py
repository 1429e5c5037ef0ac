"""The program's own regions in a traced window, as the per-layer metrics of
the train step read them.

The program names the phases of its train step with
``repro_torch.obs.trace.region``: host ops of the profiler's trace (found
here by name, whatever their category, on whichever thread opened them),
on the same clock as the device operations. ``train.forward`` and
``train.backward`` open once a microbatch on the main thread (autograd's
thread does the backward's work inside its interval), ``train.accumulate``
at each of the fp32 microbatch sums, ``optim.adamw`` once a step, and
``model.recompute`` on autograd's thread around each recomputed period,
inside a ``train.backward``. The four phases do not overlap.

A region's intervals are merged and clipped to the window. A device op
lies in a region when its launch does, whichever thread launched it.
The steps are the ``optim.adamw`` regions in the window (the capture
holds whole steps).
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from portbench.harness import trace as tr

#: The train step's phases, in the order a step runs them.
PHASES = ("train.forward", "train.backward", "train.accumulate",
          "optim.adamw")
RECOMPUTE = "model.recompute"
#: Runtime calls in which the host waits for the card; each blocking copy
#: between host and device issues one.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")

Intervals = List[Tuple[float, float]]


def intervals(t: tr.Trace, *names: str) -> Intervals:
    """The merged intervals of the host ops named ``names``, clipped to the
    window, in time order."""
    spans = sorted((max(o.start, t.start), min(o.end, t.end))
                   for o in t.host if o.name in names)
    out: List[List[float]] = []
    for s, e in spans:
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_us(a: Intervals, b: Intervals) -> float:
    """Microseconds in both of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(t: tr.Trace) -> Intervals:
    """The device's idle intervals in the window."""
    return [(s, e) for s, e, _ in tr.gaps(t)]


def within(ivs: Intervals, x: float) -> bool:
    i = bisect.bisect_right(ivs, (x, float("inf"))) - 1
    return i >= 0 and ivs[i][0] <= x <= ivs[i][1]


def launched_within(t: tr.Trace, ivs: Intervals, ops) -> list:
    """The device ops of ``ops`` whose launch lies in ``ivs``."""
    out = []
    for o in ops:
        launch = t.launches.get(o.corr)
        if launch is not None and within(ivs, launch.start):
            out.append(o)
    return out


def steps(t: tr.Trace) -> int:
    return sum(1 for o in t.host if o.name == "optim.adamw"
               and t.start <= o.start < t.end)


def train_trace(run) -> Optional[tr.Trace]:
    t = run.trace
    if run.kind != "train" or t is None or t.end <= t.start:
        return None
    return t


def idle_share(run, name: str) -> Optional[float]:
    """100 x the device's idle time inside the regions ``name`` over the
    window; None without such regions."""
    t = train_trace(run)
    ivs = intervals(t, name) if t is not None else []
    if not ivs:
        return None
    return 100.0 * overlap_us(idle(t), ivs) / (t.end - t.start)


def per_step(run, count) -> Optional[float]:
    """``count(trace, phase intervals)`` over the steps; None without the
    phases' regions or a step."""
    t = train_trace(run)
    ivs = intervals(t, *PHASES) if t is not None else []
    n = steps(t) if ivs else 0
    if not n:
        return None
    return count(t, ivs) / n

