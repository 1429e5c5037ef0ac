"""The port's perf gate: tolerance bands, polarity, failure modes, CLI.

Synthetic documents exercise the comparison semantics (as
``tests/test_perf_gate.py`` does for the reference's gate); copies of the
committed ``BENCH_perf.json`` under ``tmp_path`` exercise the gate on the
real baseline. The committed file itself is only ever read.
"""
import copy
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.perf import gate as jgate  # noqa: E402
from repro_torch.obs.metrics import Histogram  # noqa: E402
from repro_torch.perf import gate  # noqa: E402
from repro_torch.perf.sweep import SCHEMA_VERSION  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "BENCH_perf.json"
CELL = "archA/paged_kv/ch4/L13"
MMU_CELL = "mmu/paged_seq/L13"
TRANSFORM_CELL = "transform/kv1024B/L13"
SERVE_CELL = "serve/archA/cap2"
SHARDED_CELL = "sharded/archA/mesh4"
SHARDED = ["sharded/qwen2.5-3b/mesh1", "sharded/qwen2.5-3b/mesh2",
           "sharded/qwen2.5-3b/mesh4", "sharded/qwen2.5-3b/mesh8"]


def _doc(cells=None):
    if cells is None:
        cells = {CELL: _cell()}
    return {
        "schema_version": SCHEMA_VERSION, "mode": "quick", "seed": 0,
        "repeats": 3,
        "dimensions": {"archs": ["archA"], "workloads": ["paged_kv"],
                       "channel_counts": [4], "mem_latencies": [13],
                       "serve_cells": []},
        "cells": cells,
    }


def _cell(util=0.66, launch=36.0, merge=2.0, hit=0.95, spec_fixed=0.6,
          spec_adaptive=0.62, cache_hit=1.0, speedup=2.4):
    return {
        "kind": "dma", "arch": "archA", "workload": "paged_kv",
        "channels": 4, "mem_latency": 13,
        "metrics": {
            "bus_utilization": util,
            "launch_cycles_per_transfer": launch,
            "coalesce_merge_ratio": merge,
            "speculation_hit_rate": hit,
            "spec_bus_utilization_fixed4": spec_fixed,
            "spec_bus_utilization_adaptive": spec_adaptive,
            "translation_cache_hit_rate": cache_hit,
            "translation_launch_speedup": speedup,
        },
        "counters": {},
    }


def _mmu_cell(hit=0.925, stall=420.0, remap=100.0, copy_=905.0):
    return {"kind": "mmu", "workload": "paged_seq", "mem_latency": 13,
            "transfer_bytes": 256,
            "metrics": {"tlb_hit_rate": hit, "walk_stall_cycles": stall,
                        "defrag_remap_cycles": remap,
                        "defrag_copy_cycles": copy_},
            "counters": {}}


def _transform_cell(bw32=7.75, bw8=28.4, fid=0.0039, fusion=1.0):
    return {"kind": "transform", "workload": "kv_int8",
            "transfer_bytes": 1024, "mem_latency": 13,
            "metrics": {"effective_bandwidth_fp32": bw32,
                        "effective_bandwidth_int8": bw8,
                        "effective_bandwidth_gain": bw8 / bw32,
                        "fidelity_max_rel_err": fid,
                        "transform_fusion_hit_rate": fusion},
            "counters": {}}


def _serve_cell(stall=0.5, lat=(10, 12, 13, 14, 18, 21)):
    h = Histogram()
    for v in lat:
        h.record(v)
    snap = h.snapshot()
    return {"kind": "serve", "arch": "archA", "workload": "serve",
            "metrics": {"admission_stall_rate": stall,
                        "completion_poll_latency_steps": 1.0,
                        "serve_steps_per_request": 4.0,
                        "request_latency_steps_p50": snap["p50"],
                        "request_latency_steps_p99": snap["p99"],
                        "request_latency_steps": snap},
            "counters": {}}


def _sharded_cell(cycles=120.0, mesh=4):
    return {"kind": "sharded", "arch": "archA", "mesh": mesh,
            "workload": "kv_migration",
            "metrics": {"cross_shard_migration_cycles": cycles,
                        "per_shard_bus_utilization": 0.88,
                        "migration_chain_merge_ratio": 1.8,
                        "migration_overlap_ratio": 0.85,
                        "p99_migration_stall_cycles": 140.0,
                        "rebalance_convergence_steps": 5.0,
                        "throughput_retained_during_resize": 0.95,
                        "first_touch_latency_rounds": 4.0},
            "counters": {}}


def _write(tmp_path, name, doc):
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return str(p)


@pytest.fixture()
def committed(tmp_path):
    """A copy of the committed baseline, and its document."""
    doc = json.loads(BASELINE.read_text())
    return _write(tmp_path, "BENCH_perf.json", doc), doc


# ---------------------------------------------------------------------------
# The gate's data equals the reference's
# ---------------------------------------------------------------------------

def test_tolerances_polarities_and_metric_sets_equal_reference():
    assert gate.DEFAULT_TOLERANCES == jgate.DEFAULT_TOLERANCES
    assert gate.METRIC_POLARITY == jgate.METRIC_POLARITY
    assert dict(gate.HISTOGRAM_METRICS) == dict(jgate.HISTOGRAM_METRICS)
    assert gate.ALL_GATED_METRICS == jgate.ALL_GATED_METRICS
    assert gate.SERVE_GATED_METRICS == jgate.SERVE_GATED_METRICS
    assert gate.SHARDED_GATED_METRICS == jgate.SHARDED_GATED_METRICS
    for kind in ("dma", "mmu", "transform", "serve", "sharded"):
        assert tuple(gate.metrics_for_cell({"kind": kind})) == \
            tuple(jgate.metrics_for_cell({"kind": kind}))


def test_summaries_equal_reference_on_the_committed_baseline():
    doc = json.loads(BASELINE.read_text())
    for name in ("speculation_summary", "sharded_summary", "mmu_summary",
                 "translation_summary", "transform_summary",
                 "serve_latency_summary"):
        assert getattr(gate, name)(doc) == getattr(jgate, name)(doc), name


# ---------------------------------------------------------------------------
# Comparison semantics on synthetic documents
# ---------------------------------------------------------------------------

def test_identical_documents_pass():
    base = _doc({CELL: _cell(), MMU_CELL: _mmu_cell(),
                 TRANSFORM_CELL: _transform_cell()})
    assert gate.compare(base, copy.deepcopy(base)) == []


@pytest.mark.parametrize("cell,make,metric,factor", [
    (CELL, _cell, "bus_utilization", 0.9),
    (CELL, _cell, "launch_cycles_per_transfer", 1.1),
    (MMU_CELL, _mmu_cell, "tlb_hit_rate", 0.9),
    (MMU_CELL, _mmu_cell, "defrag_remap_cycles", 1.1),
    (TRANSFORM_CELL, _transform_cell, "effective_bandwidth_int8", 0.9),
    (TRANSFORM_CELL, _transform_cell, "fidelity_max_rel_err", 1.2),
])
def test_injected_regression_fails_named(cell, make, metric, factor):
    base, cur = _doc({cell: make()}), _doc({cell: make()})
    cur["cells"][cell]["metrics"][metric] *= factor
    regs = gate.compare(base, cur)
    assert [(r.cell, r.metric) for r in regs] == [(cell, metric)]
    assert cell in regs[0].message and metric in regs[0].message
    assert regs[0].rel_change == pytest.approx(factor - 1, abs=1e-9)


def test_polarity_and_improvements():
    base, up, down = _doc(), _doc(), _doc()
    up["cells"][CELL]["metrics"]["launch_cycles_per_transfer"] *= 1.2
    down["cells"][CELL]["metrics"]["launch_cycles_per_transfer"] *= 0.8
    assert [r.metric for r in gate.compare(base, up)] == \
        ["launch_cycles_per_transfer"]
    assert gate.compare(base, down) == []
    better = _doc({MMU_CELL: _mmu_cell(hit=1.0, stall=10.0, remap=50.0)})
    assert gate.compare(_doc({MMU_CELL: _mmu_cell()}), better) == []


def test_within_tolerance_jitter_passes_and_override_widens():
    base, cur = _doc(), _doc()
    m = cur["cells"][CELL]["metrics"]
    m["bus_utilization"] *= 0.99
    m["launch_cycles_per_transfer"] *= 1.03
    assert gate.compare(base, cur) == []
    m["bus_utilization"] = 0.66 * 0.95
    assert len(gate.compare(base, cur)) == 1
    assert gate.compare(base, cur, tolerances={"bus_utilization": 0.10}) \
        == []


def test_serve_and_sharded_cells_keep_their_gate_logic():
    base = _doc({SERVE_CELL: _serve_cell(), SHARDED_CELL: _sharded_cell()})
    worse = _doc({SERVE_CELL: _serve_cell(stall=0.7,
                                          lat=(10, 12, 13, 14, 18, 60)),
                  SHARDED_CELL: _sharded_cell(cycles=150.0)})
    assert sorted(r.metric for r in gate.compare(base, worse)) == [
        "admission_stall_rate", "cross_shard_migration_cycles",
        "request_latency_steps.p95", "request_latency_steps.p99",
        "request_latency_steps_p99"]


@pytest.mark.parametrize("cell,make,metric", [
    (CELL, _cell, "speculation_hit_rate"),
    (MMU_CELL, _mmu_cell, "walk_stall_cycles"),
    (TRANSFORM_CELL, _transform_cell, "transform_fusion_hit_rate"),
])
def test_missing_metric_errors(cell, make, metric):
    base, cur = _doc({cell: make()}), _doc({cell: make()})
    del cur["cells"][cell]["metrics"][metric]
    with pytest.raises(gate.GateError, match=f"{metric}.*missing from cur"):
        gate.compare(base, cur)
    del base["cells"][cell]["metrics"][metric]
    with pytest.raises(gate.GateError, match="missing from.*baseline"):
        gate.compare(base, cur)


def test_missing_cell_and_malformed_documents_error():
    with pytest.raises(gate.GateError, match="missing from current"):
        gate.compare(_doc(), _doc({"other/cell/ch1/L1": _cell()}))
    with pytest.raises(gate.GateError, match="no cells"):
        gate.check_schema({"schema_version": SCHEMA_VERSION, "cells": {}})
    for key in ("dimensions", "mode", "seed", "repeats"):
        doc = _doc()
        del doc[key]
        with pytest.raises(gate.GateError, match="malformed"):
            gate.check_schema(doc)
    base = _doc()
    del base["cells"][CELL]["metrics"]
    with pytest.raises(gate.GateError, match="malformed"):
        gate.compare(base, _doc())


def test_schema_version_mismatch_errors():
    cur = _doc()
    cur["schema_version"] = SCHEMA_VERSION + 1
    with pytest.raises(gate.GateError, match="schema_version"):
        gate.compare(_doc(), cur)
    assert SCHEMA_VERSION == 8


def test_quick_subset_keeps_quick_cells_and_unported_kinds():
    doc = _doc({f"archA/paged_kv/ch{ch}/L{lat}":
                dict(_cell(), channels=ch, mem_latency=lat)
                for ch in (1, 4) for lat in (1, 13)})
    doc["cells"][SERVE_CELL] = _serve_cell()
    doc["dimensions"].update(channel_counts=[1, 4], mem_latencies=[1, 13])
    sub, dropped = gate.quick_subset(doc)
    assert set(sub["cells"]) == {CELL, SERVE_CELL} and dropped == 3


# ---------------------------------------------------------------------------
# ported_subset and the committed baseline (copies under tmp_path)
# ---------------------------------------------------------------------------

def test_ported_subset_names_exactly_the_serve_and_sharded_cells():
    """Every kind is ported: the subset is the whole baseline, its serve
    and sharded cells included, and drops nothing."""
    doc = json.loads(BASELINE.read_text())
    sub, dropped = gate.ported_subset(doc)
    assert dropped == []
    assert sub == doc and len(sub["cells"]) == 91
    assert {c["kind"] for c in sub["cells"].values()} == \
        {"dma", "mmu", "transform", "serve", "sharded"}
    assert sub["dimensions"]["serve_cells"] == ["serve/qwen2.5-3b/cap2"]
    assert sub["dimensions"]["sharded_cells"] == SHARDED
    assert sorted(k for k, c in sub["cells"].items()
                  if c["kind"] == "sharded") == SHARDED
    assert gate.NOT_PORTED_KINDS == ()
    only = _doc({SHARDED_CELL: _sharded_cell()})
    assert gate.ported_subset(only) == (only, [])
    with pytest.raises(gate.GateError, match="no cells"):
        gate.ported_subset(_doc({}))


def test_committed_copy_against_itself_and_an_injected_regression(committed):
    _, doc = committed
    base, _ = gate.ported_subset(doc)
    assert gate.compare(base, copy.deepcopy(base)) == []
    cur = copy.deepcopy(base)
    key = "qwen3-14b/moe_dispatch/ch4/L100"
    cur["cells"][key]["metrics"]["bus_utilization"] *= 0.9
    cur["cells"]["mmu/paged_seq/L100"]["metrics"]["walk_stall_cycles"] *= 1.1
    regs = gate.compare(base, cur)
    assert sorted((r.cell, r.metric) for r in regs) == [
        ("mmu/paged_seq/L100", "walk_stall_cycles"),
        (key, "bus_utilization")]
    del cur["cells"]["transform/kv4096B/L13"]
    with pytest.raises(gate.GateError, match="transform/kv4096B/L13"):
        gate.compare(base, cur)


def test_cli_exit_codes_on_committed_copies(committed, tmp_path, capsys):
    path, doc = committed
    cur, _ = gate.ported_subset(doc)
    same = _write(tmp_path, "same.json", cur)
    assert gate.main(["--baseline", path, "--current", same]) == 0
    out = capsys.readouterr().out
    assert "not ported" not in out
    assert "PASS — 91 cells" in out

    bad = copy.deepcopy(cur)
    bad["cells"]["dbrx-132b/paged_kv/ch4/L13"]["metrics"][
        "coalesce_merge_ratio"] *= 0.9
    badp = _write(tmp_path, "bad.json", bad)
    assert gate.main(["--baseline", path, "--current", badp]) == 1
    assert "dbrx-132b/paged_kv/ch4/L13" in capsys.readouterr().err
    assert gate.main(["--baseline", path, "--current", badp,
                      "--tolerance", "coalesce_merge_ratio=0.2"]) == 0
    assert gate.main(["--baseline", path, "--current", badp,
                      "--tolerance", "nonsense=0.1"]) == 2

    short = copy.deepcopy(cur)
    del short["cells"]["mmu/paged_seq/L13"]
    shortp = _write(tmp_path, "short.json", short)
    assert gate.main(["--baseline", path, "--current", shortp]) == 2

    vers = copy.deepcopy(cur)
    vers["schema_version"] = 99
    versp = _write(tmp_path, "vers.json", vers)
    assert gate.main(["--baseline", path, "--current", versp]) == 2
    assert gate.main(["--baseline", str(tmp_path / "nope.json")]) == 2
    assert json.loads(Path(path).read_text()) == doc     # never rewritten


def test_cli_has_no_update_baseline(committed):
    path, _ = committed
    with pytest.raises(SystemExit):
        gate.main(["--baseline", path, "--update-baseline"])


def test_cli_refuses_to_write_the_committed_baseline(committed, capsys):
    path, doc = committed
    cur = _write(Path(path).parent, "cur.json", gate.ported_subset(doc)[0])
    assert gate.main(["--baseline", path, "--current", cur,
                      "--out", str(BASELINE)]) == 2
    assert "never writes" in capsys.readouterr().err


def test_cli_reruns_the_sweep_on_the_cpu_and_passes(committed, tmp_path,
                                                    capsys):
    """The whole port: the baseline's spec re-run on the CPU, 91 cells."""
    path, _ = committed
    out = str(tmp_path / "port.json")
    assert gate.main(["--baseline", path, "--device", "cpu",
                      "--out", out]) == 0
    text = capsys.readouterr().out
    assert "re-running sweep: mode=quick seed=0 repeats=3" in text
    assert "PASS — 91 cells within tolerance" in text
    assert "not ported" not in text
    cells = json.loads(Path(out).read_text())["cells"]
    assert len(cells) == 91
    base = json.loads(BASELINE.read_text())["cells"]
    for key in SHARDED:
        assert cells[key] == base[key], key
