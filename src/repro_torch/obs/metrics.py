"""Counters, gauges, and mergeable fixed-bucket histograms.

The histogram layout (DESIGN.md §8) is width-1 *linear* buckets below
``max_exact`` followed by log2 buckets above it:

* bucket ``i`` for ``i < max_exact`` holds exactly the integer value ``i``
  (so percentiles over small-integer samples — serve request latencies in
  steps, poll latencies — are *exact*, matching
  ``np.percentile(..., method="inverted_cdf")``);
* bucket ``max_exact + k`` holds ``[max_exact * 2**k, max_exact * 2**(k+1))``
  (log2 width, bounded relative error for large wall-clock samples).

Buckets are plain count lists, so cross-shard merge is element-wise
addition — associative and commutative by construction, which is what lets
per-shard registries fold into one document in any order.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Iterator, List, Optional, Union

Number = Union[int, float]


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def merge(self, other: "Counter") -> None:
        self.value += other.value

    def snapshot(self) -> Dict[str, Number]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value plus its observed peak."""

    __slots__ = ("value", "peak", "n")

    def __init__(self) -> None:
        self.value = 0.0
        self.peak = 0.0
        self.n = 0

    def set(self, v: Number) -> None:
        self.value = float(v)
        self.n += 1
        if v > self.peak:
            self.peak = float(v)

    def merge(self, other: "Gauge") -> None:
        # merge keeps the peak; "last value" across shards is ill-defined,
        # so the merged value is the max as well.
        self.n += other.n
        self.peak = max(self.peak, other.peak)
        self.value = max(self.value, other.value)

    def snapshot(self) -> Dict[str, Number]:
        return {"type": "gauge", "value": self.value, "peak": self.peak,
                "n": self.n}


class Histogram:
    """Fixed-bucket histogram: width-1 linear below ``max_exact``, log2 above.

    Percentiles use the nearest-rank definition (the smallest recorded
    bucket whose cumulative count reaches ``ceil(q/100 * n)``), returning
    the bucket *lower bound* — exact for integer samples below
    ``max_exact``, a <=2x-wide floor for the log2 range.
    """

    __slots__ = ("max_exact", "log2_buckets", "counts", "n", "total",
                 "min", "max")

    def __init__(self, max_exact: int = 64, log2_buckets: int = 32) -> None:
        if max_exact < 1 or log2_buckets < 1:
            raise ValueError("max_exact and log2_buckets must be >= 1")
        self.max_exact = int(max_exact)
        self.log2_buckets = int(log2_buckets)
        self.counts: List[int] = [0] * (self.max_exact + self.log2_buckets)
        self.n = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    # -- recording ---------------------------------------------------------

    def bucket_index(self, v: Number) -> int:
        if v < 0:
            v = 0
        if v < self.max_exact:
            return int(v)
        k = int(math.floor(math.log2(float(v) / self.max_exact)))
        if k >= self.log2_buckets:
            k = self.log2_buckets - 1
        return self.max_exact + k

    def bucket_lo(self, i: int) -> float:
        """Inclusive lower bound of bucket ``i`` (the percentile estimate)."""
        if i < self.max_exact:
            return float(i)
        return float(self.max_exact * (2 ** (i - self.max_exact)))

    def record(self, v: Number) -> None:
        fv = float(v)
        self.counts[self.bucket_index(v)] += 1
        self.n += 1
        self.total += fv
        if self.min is None or fv < self.min:
            self.min = fv
        if self.max is None or fv > self.max:
            self.max = fv

    # -- reading -----------------------------------------------------------

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile (lower bucket bound); 0.0 when empty."""
        if self.n == 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self.n))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.bucket_lo(i)
        return self.bucket_lo(len(self.counts) - 1)   # unreachable guard

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    # -- merge / serialization --------------------------------------------

    def merge(self, other: "Histogram") -> None:
        if (other.max_exact != self.max_exact
                or other.log2_buckets != self.log2_buckets):
            raise ValueError("cannot merge histograms with different "
                             "bucket layouts")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.total += other.total
        if other.min is not None:
            self.min = other.min if self.min is None else min(self.min,
                                                              other.min)
        if other.max is not None:
            self.max = other.max if self.max is None else max(self.max,
                                                              other.max)

    def snapshot(self) -> Dict[str, object]:
        return {
            "type": "histogram",
            "max_exact": self.max_exact,
            "log2_buckets": self.log2_buckets,
            "counts": list(self.counts),
            "n": self.n,
            "sum": self.total,
            "min": 0.0 if self.min is None else self.min,
            "max": 0.0 if self.max is None else self.max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }

    @classmethod
    def from_snapshot(cls, snap: Dict[str, object]) -> "Histogram":
        h = cls(max_exact=int(snap["max_exact"]),
                log2_buckets=int(snap["log2_buckets"]))
        counts = list(snap["counts"])
        if len(counts) != len(h.counts):
            raise ValueError("snapshot counts length does not match layout")
        h.counts = [int(c) for c in counts]
        h.n = int(snap["n"])
        h.total = float(snap["sum"])
        if h.n:
            h.min = float(snap["min"])
            h.max = float(snap["max"])
        return h


Instrument = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors.

    ``merge`` folds another registry in (cross-shard aggregation);
    instruments are created on demand so shards with disjoint metric sets
    merge cleanly.
    """

    def __init__(self) -> None:
        self._instruments: Dict[str, Instrument] = {}

    def _get(self, name, kind, factory):
        inst = self._instruments.get(name)
        if inst is None:
            inst = factory()
            self._instruments[name] = inst
        elif not isinstance(inst, kind):
            raise TypeError(f"metric {name!r} is {type(inst).__name__}, "
                            f"not {kind.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def histogram(self, name: str, *, max_exact: int = 64,
                  log2_buckets: int = 32) -> Histogram:
        return self._get(
            name, Histogram,
            lambda: Histogram(max_exact=max_exact,
                              log2_buckets=log2_buckets))

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def __len__(self) -> int:
        return len(self._instruments)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def get(self, name: str) -> Optional[Instrument]:
        return self._instruments.get(name)

    def merge(self, other: "MetricsRegistry") -> None:
        for name in other.names():
            inst = other._instruments[name]
            if isinstance(inst, Counter):
                self.counter(name).merge(inst)
            elif isinstance(inst, Gauge):
                self.gauge(name).merge(inst)
            else:
                mine = self.histogram(name, max_exact=inst.max_exact,
                                      log2_buckets=inst.log2_buckets)
                mine.merge(inst)

    def reset(self) -> None:
        self._instruments.clear()

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        return {name: self._instruments[name].snapshot()
                for name in self.names()}

    def jsonl_lines(self) -> Iterator[str]:
        """One JSON object per metric, name-sorted (the flat dump format)."""
        for name, snap in self.snapshot().items():
            yield json.dumps({"name": name, **snap}, sort_keys=True)
