"""One run of one cell: the manifest and the files it names, the checks
around the run, the readers of the metrics, the last line.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by its name in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<mix>.json``, ``kinds/<kind>.py``
(the runner of a mix's kind), ``metrics/<metric>.py`` (its reader) and
``limits/<cell>.json`` (the limits of the cell's comparison).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
#: Top-level module names that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age() -> float:
    """Seconds since this process started (its start tick in /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell of the manifest with the files it names, read."""
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists; else, for a per-layer metric, every cell reporting the
    end-to-end metric it ``moves``; else every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def cell(name: str) -> Cell:
    """The cell ``name`` with its configuration, mix and metrics."""
    man = manifest()
    w = next((w for w in man["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in man["configs"] if c["name"] == w["config"])
    with open(ROOT / cfg["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    e2e = [m for m in man["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"] if _reports(m, name, names)]
    return Cell(name, config, mix, w["chips"], e2e, per)


@dataclasses.dataclass
class Run:
    """What a run measured, for the metrics' readers: the window's host
    seconds and counts (``counts``), the traced window (``trace``) and
    what the runner adds (``extra``)."""
    kind: str
    arch: dict
    mix: dict
    window_s: float = 0.0
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Any = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def read_metrics(metrics: List[dict], run: Run) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something to read."""
    out = {}
    for m in metrics:
        path = BENCH / "metrics" / f"{m['name']}.py"
        value = load_module(path).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


@dataclasses.dataclass
class Ctx:
    """What a runner (``kinds/<kind>.py``) is given: the cell, the run's
    arguments, the device, the program's model configuration and the
    reference's architecture, and the process's start on the
    ``time.perf_counter`` clock."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    port_cfg: Any
    arch: dict
    control: bool = False
    #: Host seconds of whole steps the traced run profiles.
    trace_seconds: float = 1.0


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> tuple:
    """(correct, checks): every number at or under its limit, and every
    limit's number present and finite; a cell without limits is never
    correct."""
    checks, ok = {}, bool(limits)
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim["limit"]
        ok = ok and good
        checks[name] = {"value": v, "limit": lim["limit"]}
    return ok, checks


def limits(cell_name: str) -> Dict[str, dict]:
    """The limits of a cell's comparison, by number (none: no limits file)."""
    path = BENCH / "limits" / f"{cell_name}.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)["limits"]


def forbidden_modules() -> List[str]:
    """Modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def device_info(torch, count: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def now() -> float:
    return time.perf_counter()


def note(**kw) -> None:
    """A progress line on standard error (phase seconds and the like)."""
    print(json.dumps({"portbench": kw}), file=sys.stderr, flush=True)


def norm(t, other=None, chunk: int = 1 << 26) -> float:
    """The L2 norm of ``t`` (or of ``t - other``), summed in fp64 over
    pieces of ``chunk`` elements, so no whole-leaf temporary is made."""
    import torch
    a = t.reshape(-1)
    b = None if other is None else other.reshape(-1)
    total = None
    for i in range(0, a.numel(), chunk):
        x = a[i:i + chunk].float()
        if b is not None:
            x = x - b[i:i + chunk].float()
        s = x.square().sum(dtype=torch.float64)
        total = s if total is None else total + s
    return 0.0 if total is None else math.sqrt(float(total))
