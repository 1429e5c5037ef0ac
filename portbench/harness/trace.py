"""The device trace of a traced run: ``torch.profiler`` over whole steps of
the measured window, read from its exported Chrome trace into device
operations, their launches, host operations and the benchmark's own
spans (``record_function`` names), and reduced to what the per-layer
metrics and the breakdown read.

Spans the harness records: ``portbench.window`` around the traced steps
(ending in a synchronise, so every operation they launched lies inside),
``train.step`` around each step, and ``optim.apply``
around the program's optimizer update (the harness wraps that call in a
traced run only).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

#: Chrome-trace categories of operations that run on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Categories of host-side launches (they carry the correlation id).
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: Categories of host operations and spans.
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "portbench.window"


@dataclasses.dataclass
class Op:
    name: str
    start: float          # microseconds, trace clock
    dur: float
    cat: str
    tid: int = 0
    corr: Optional[int] = None

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclasses.dataclass
class Trace:
    """A traced window: device ops, host ops and spans, launches by
    correlation id, the window's bounds (microseconds)."""
    device: List[Op]
    host: List[Op]
    launches: Dict[int, Op]
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def kernels(self) -> List[Op]:
        return [o for o in self.device if o.cat == "kernel"]

    def spans(self, name: str) -> List[Op]:
        return [o for o in self.host if o.cat == "user_annotation"
                and o.name == name]

    def launched_in(self, name: str) -> List[Op]:
        """Device ops launched while a span ``name`` was open on the
        launching thread."""
        spans = sorted((s.start, s.end, s.tid) for s in self.spans(name))
        starts = [s[0] for s in spans]
        out = []
        for op in self.device:
            launch = self.launches.get(op.corr)
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch.start) - 1
            while i >= 0 and spans[i][1] >= launch.start:
                if spans[i][2] == launch.tid:
                    out.append(op)
                    break
                i -= 1
        return out


def parse(events: List[dict]) -> Trace:
    """A :class:`Trace` from Chrome-trace events, clipped to the
    ``portbench.window`` span."""
    device, host, launches = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        op = Op(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
                cat, int(e.get("tid", 0)) if str(e.get("tid", 0)).lstrip(
                    "-").isdigit() else hash(e.get("tid")),
                args.get("correlation"))
        if cat in DEVICE_CATS:
            device.append(op)
        elif cat in LAUNCH_CATS:
            if op.corr is not None:
                launches[op.corr] = op
        elif cat in HOST_CATS:
            host.append(op)
    win = [o for o in host if o.name == WINDOW]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} span")
    start, end = win[0].start, win[0].end
    device = sorted((o for o in device if o.end > start and o.start < end),
                    key=lambda o: o.start)
    return Trace(device, host, launches, start, end)


def union_us(ops: List[Op], start: float, end: float) -> float:
    """Microseconds inside [start, end] in which some op of ``ops`` ran."""
    total, cur_s, cur_e = 0.0, None, None
    for o in sorted(ops, key=lambda o: o.start):
        s, e = max(o.start, start), min(o.end, end)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(tr: Trace) -> List[Tuple[float, float, Optional[Op]]]:
    """The device's idle intervals in the window: (start, end, the device
    op that ends it, or None for the tail)."""
    out, busy_to = [], tr.start
    for o in tr.device:
        if o.start > busy_to:
            out.append((busy_to, o.start, o))
        busy_to = max(busy_to, o.end)
    if busy_to < tr.end:
        out.append((busy_to, tr.end, None))
    return out


def _host_at(tr: Trace, queries: List[Tuple[float, int]],
             main: int) -> List[str]:
    """For each (time, thread), the innermost host op or span open on that
    thread then, as "outer span / op" (a thread other than ``main``, the
    one with the spans, such as autograd's, is "other thread"); a sweep
    over the ops in time."""
    edges = []
    for i, o in enumerate(tr.host):
        edges.append((o.start, 0, i))
        edges.append((o.end, 2, i))
    for j, (t, _) in enumerate(queries):
        edges.append((t, 1, j))
    edges.sort()
    stacks: Dict[int, list] = collections.defaultdict(list)
    labels = [""] * len(queries)
    for _, kind, i in edges:
        if kind == 0:
            stacks[tr.host[i].tid].append(i)
        elif kind == 2:
            st = stacks[tr.host[i].tid]
            if i in st:
                st.remove(i)
        else:
            t, tid = queries[i]
            st = stacks.get(tid) or []
            spans = [tr.host[k].name for k in st
                     if tr.host[k].cat == "user_annotation"
                     and tr.host[k].name != WINDOW]
            ops = [tr.host[k].name for k in st
                   if tr.host[k].cat == "cpu_op"]
            outer = spans[-1] if spans else (
                "outside the steps" if tid == main else "other thread")
            labels[i] = f"{outer} / {ops[-1] if ops else 'python between ops'}"
    return labels


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device ops that took most time, and the idle time by what the
    host was doing (summed over the gaps), each at most ``top``."""
    by_name = collections.Counter()
    for o in tr.device:
        by_name[o.name[:120]] += o.dur / 1e6
    idle = gaps(tr)
    main = max(collections.Counter(
        o.tid for o in tr.host if o.cat == "user_annotation").items(),
        key=lambda kv: kv[1], default=(0, 0))[0]
    queries = []
    for s, e, nxt in idle:
        launch = tr.launches.get(nxt.corr) if nxt is not None else None
        queries.append(((s + e) / 2, launch.tid if launch else main))
    by_label = collections.Counter()
    for (s, e, _), label in zip(idle, _host_at(tr, queries, main)):
        by_label[label] += (e - s) / 1e6
    return {"device_ops": [[k, v] for k, v in by_name.most_common(top)],
            "idle_gaps": [[k, v] for k, v in by_label.most_common(top)]}


class Capture:
    """``with Capture(torch):`` profiles the block (the traced window);
    :meth:`read` then exports and reads the trace, outside the measured
    window, into a :class:`Trace`."""

    def __init__(self, torch):
        self.torch = torch
        self.done = False

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = record_function(WINDOW)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        self.done = True
        return False

    def read(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        del self.prof
        return parse(events)
