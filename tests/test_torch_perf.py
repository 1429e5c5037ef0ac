"""Port parity: the perf sweep (workloads, runtime passes, the document).

The port's workloads must be the reference's byte for byte, its runtime
pass must count what the reference's counts, and its sweep must reproduce
the committed ``BENCH_perf.json`` cells it runs exactly: metrics and
counters, the ``dma``, ``mmu``, ``transform``, ``serve`` and ``sharded``
kinds alike. Each cell depends only on its own config and workload, so a
subset of configs reproduces the committed cells of those configs (and
every cell of the other kinds). Runs on the CPU.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.descriptor import to_packed as jto_packed  # noqa: E402
from repro.perf import sweep as jsweep  # noqa: E402
from repro.perf import workloads as jw  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core.descriptor import to_packed  # noqa: E402
from repro_torch.perf import gate, serve_cell, sweep  # noqa: E402
from repro_torch.perf.workloads import (  # noqa: E402
    QUICK,
    SCALES,
    WORKLOAD_NAMES,
    Scale,
    arch_params,
    generate,
    zipf_page_traffic,
)

ROOT = Path(__file__).resolve().parents[1]
TINY = Scale("tiny", n_bursts=1, burst_len=24, pool_elems=1 << 12,
             max_len=128, ring_capacity=64, sim_transfers=60)
#: Configs whose committed cells the CPU sweep reproduces: on CUDA pools
#: some drains of deepseek-v2-236b's chain_mix and qwen3-14b's moe_dispatch
#: take the descriptor_copy kernel route, and seamless-m4t-medium has the
#: smallest rows (8 fp32).
SUBSET = ("deepseek-v2-236b", "qwen3-14b", "seamless-m4t-medium")


@pytest.fixture(scope="module")
def baseline():
    return json.loads((ROOT / "BENCH_perf.json").read_text())


@pytest.fixture(scope="module")
def subset_doc(baseline):
    ported, _ = gate.ported_subset(baseline)
    spec = sweep.spec_from_doc(ported)
    spec = dataclasses.replace(spec, archs=SUBSET)
    return sweep.run_sweep(spec, device="cpu")


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("arch", list_archs())
def test_generate_is_the_reference_byte_for_byte(arch, scale):
    for name in WORKLOAD_NAMES:
        want = jw.generate(name, jget_config(arch), jw.SCALES[scale], 0)
        got = generate(name, get_config(arch), SCALES[scale], 0)
        assert (got.name, got.arch, got.pool_elems, got.transfer_bytes,
                got.meta) == (want.name, want.arch, want.pool_elems,
                              want.transfer_bytes, want.meta)
        assert len(got.chains) == len(want.chains)
        for g, w in zip(got.chains, want.chains):
            for f in ("src", "dst", "length", "nxt", "config"):
                assert np.array_equal(np.asarray(getattr(g, f)),
                                      np.asarray(getattr(w, f))), (name, f)
            assert np.asarray(to_packed(g)).tobytes() == \
                np.asarray(jto_packed(w)).tobytes(), name


def test_scales_and_arch_params_equal_reference():
    for name in SCALES:
        assert SCALES[name].__dict__ == jw.SCALES[name].__dict__
    for arch in list_archs():
        assert arch_params(get_config(arch)).__dict__ == \
            jw.arch_params(jget_config(arch)).__dict__
    assert len({arch_params(get_config(a)).page_elems
                for a in list_archs()}) > 1


def test_generators_stay_in_bounds_and_depend_on_seed():
    for arch in list_archs():
        for name in WORKLOAD_NAMES:
            wl = generate(name, get_config(arch), TINY, seed=0)
            assert wl.chains and wl.transfer_bytes % 8 == 0
            for d in wl.chains:
                src, dst, ln = (np.asarray(x, np.int64)
                                for x in (d.src, d.dst, d.length))
                assert (ln > 0).all() and (src >= 0).all()
                assert (src + ln <= TINY.pool_elems).all()
                assert (dst + ln <= TINY.pool_elems).all()
    cfg = get_config(list_archs()[0])
    for name in WORKLOAD_NAMES:
        a, c = generate(name, cfg, TINY, 3), generate(name, cfg, TINY, 4)
        assert any(not np.array_equal(np.asarray(x.src), np.asarray(y.src))
                   for x, y in zip(a.chains, c.chains)), name


def test_zipf_page_traffic_equals_reference():
    for seed in (0, 7):
        want = jw.zipf_page_traffic(64, 512, alpha=1.1,
                                    rng=np.random.default_rng(seed))
        got = zipf_page_traffic(64, 512, alpha=1.1,
                                rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="num_pages"):
        zipf_page_traffic(0, 10, rng=np.random.default_rng(0))
    with pytest.raises(ValueError, match="whole page space"):
        zipf_page_traffic(4, 10, rng=np.random.default_rng(0),
                          hot_pages=np.arange(3))


def test_moe_storm_defeats_prefetcher_paged_kv_does_not():
    from repro_torch.runtime import coalesce
    cfg = get_config("dbrx-132b")
    kv = generate("paged_kv", cfg, TINY, seed=0)
    moe = generate("moe_dispatch", cfg, TINY, seed=0)
    _, kv_stats = coalesce(kv.chains[0], max_len=TINY.max_len)
    _, moe_stats = coalesce(moe.chains[0], max_len=TINY.max_len)
    assert kv_stats.input_hit_rate > 0.9
    assert moe_stats.input_hit_rate < 0.5
    assert kv_stats.merge_ratio > moe_stats.merge_ratio


# ---------------------------------------------------------------------------
# Runtime pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", WORKLOAD_NAMES)
@pytest.mark.parametrize("arch", ["dbrx-132b", "seamless-m4t-medium"])
def test_runtime_pass_equals_reference(arch, workload):
    want = jsweep._run_runtime_pass(arch, workload, 4, QUICK, 0)
    got = sweep._run_runtime_pass(arch, workload, 4, QUICK, 0, device="cpu")
    for k in ("merge_ratio", "hit_rate", "translation_hit_rate",
              "transfer_bytes", "counters"):
        assert got[k] == want[k], k
    assert got["launch_us_per_descriptor"] > 0.0


def test_runtime_pass_runs_on_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sweep._run_runtime_pass("dbrx-132b", "paged_kv", 1, TINY, 0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sweep.run_sweep(sweep.default_spec(
            "quick", 0, archs=["dbrx-132b"], workloads=["paged_kv"],
            channel_counts=[1], mem_latencies=[13], repeats=1))


# ---------------------------------------------------------------------------
# The sweep document against the committed baseline
# ---------------------------------------------------------------------------

def test_sweep_reproduces_committed_cells_exactly(baseline, subset_doc):
    cells = subset_doc["cells"]
    kinds = {}
    for key, cell in cells.items():
        kinds[cell["kind"]] = kinds.get(cell["kind"], 0) + 1
        assert cell == baseline["cells"][key], key
    assert kinds == {"dma": 8 * len(SUBSET), "mmu": 2, "transform": 4,
                     "serve": 1, "sharded": 4}
    for dim in ("serve_cells", "sharded_cells", "mesh_sizes"):
        assert subset_doc["dimensions"][dim] == baseline["dimensions"][dim]


def test_sweep_subset_gates_clean(baseline, subset_doc):
    ported, dropped = gate.ported_subset(baseline)
    ported["cells"] = {k: c for k, c in ported["cells"].items()
                       if k in subset_doc["cells"]}
    assert gate.compare(ported, subset_doc) == []
    assert dropped == []


def test_sweep_document_is_bit_for_bit_deterministic():
    spec = sweep.default_spec("quick", 0, archs=["qwen2.5-3b"],
                              workloads=["paged_kv", "moe_dispatch"],
                              channel_counts=[2], mem_latencies=[13],
                              repeats=2, include_transforms=False,
                              iotlb=False)
    d1 = sweep.run_sweep(spec, device="cpu")
    d2 = sweep.run_sweep(spec, device="cpu")
    assert json.dumps(d1, sort_keys=True) == json.dumps(d2, sort_keys=True)
    want = jsweep.run_sweep(jsweep.default_spec(
        "quick", 0, archs=["qwen2.5-3b"],
        workloads=["paged_kv", "moe_dispatch"], channel_counts=[2],
        mem_latencies=[13], repeats=2, include_serve=False,
        include_sharded=False, include_transforms=False, iotlb=False))
    assert d1["cells"] == want["cells"]
    assert d1["schema_version"] == want["schema_version"] == 8
    assert d1["iotlb_enabled"] is False


def test_adaptive_matches_fixed_on_sequential_beats_it_on_storms(subset_doc):
    checked = 0
    for key, cell in subset_doc["cells"].items():
        if cell["kind"] != "dma":
            continue
        m = cell["metrics"]
        fixed = m["spec_bus_utilization_fixed4"]
        adaptive = m["spec_bus_utilization_adaptive"]
        if cell["workload"] in ("paged_kv", "defrag_churn"):
            assert adaptive >= fixed - 1e-12, key
            checked += 1
        elif cell["workload"] == "moe_dispatch":
            assert adaptive > fixed, key
            assert cell["speculation"]["adaptive"]["final_depth"] < 4, key
            checked += 1
    assert checked == 6 * len(SUBSET)


def test_no_translation_cache_is_self_describing():
    spec = sweep.default_spec("quick", 0, archs=["dbrx-132b"],
                              workloads=["paged_kv"], channel_counts=[1],
                              mem_latencies=[13], repeats=1,
                              include_transforms=False, iotlb=False,
                              translation=False)
    doc = sweep.run_sweep(spec, device="cpu")
    (cell,) = doc["cells"].values()
    assert doc["translation_cache_enabled"] is False
    assert cell["metrics"]["translation_cache_hit_rate"] == 0.0
    assert cell["metrics"]["translation_launch_speedup"] == 1.0


def test_launch_us_is_reported_and_never_stored():
    lu = {}
    spec = sweep.default_spec("quick", 0, archs=["dbrx-132b"],
                              workloads=["moe_dispatch"], channel_counts=[2],
                              mem_latencies=[13], repeats=2,
                              include_transforms=False, iotlb=False)
    doc = sweep.run_sweep(spec, device="cpu", launch_us=lu)
    assert list(lu) == ["dbrx-132b/moe_dispatch/ch2"]
    assert len(lu["dbrx-132b/moe_dispatch/ch2"]) == 2
    assert all(v > 0 for v in lu["dbrx-132b/moe_dispatch/ch2"])
    assert "launch_us" not in json.dumps(doc)
    assert "seconds" not in json.dumps(doc)


@pytest.mark.parametrize("flag", ["include_serve", "include_sharded"])
def test_unported_cells_raise_never_skip(flag):
    """Every cell kind is ported: the serve and sharded cells run when
    asked for (the document-level run is in the tests above); neither is
    on by default."""
    assert getattr(sweep.default_spec("quick", 0, **{flag: True}), flag)
    spec = sweep.default_spec("quick", 0)
    assert spec.include_serve is False and spec.include_sharded is False
    if flag == "include_sharded":
        doc = sweep.run_sweep(sweep.default_spec(
            "quick", 0, archs=[], include_sharded=True, mesh_sizes=[1, 2],
            include_transforms=False, iotlb=False), device="cpu")
        assert doc["dimensions"]["sharded_cells"] == [
            "sharded/qwen2.5-3b/mesh1", "sharded/qwen2.5-3b/mesh2"]
        assert set(doc["cells"]) == set(doc["dimensions"]["sharded_cells"])


def test_spec_from_doc_refuses_unported_cells(baseline):
    """No cell of the baseline is refused: its spec asks for every kind."""
    spec = sweep.spec_from_doc(baseline)
    assert spec == sweep.spec_from_doc(gate.ported_subset(baseline)[0])
    assert (spec.mode, spec.seed, spec.repeats) == ("quick", 0, 3)
    assert spec.channel_counts == (4,) and spec.mem_latencies == (13, 100)
    assert len(spec.archs) == 10 and spec.iotlb and spec.include_transforms
    assert spec.include_serve and spec.include_sharded
    assert spec.mesh_sizes == (1, 2, 4, 8)


def test_serve_cell_equals_the_committed_cell_exactly(baseline):
    """Metrics and counters of ``serve/qwen2.5-3b/cap2``, bit for bit: they
    are scheduling outcomes, whatever the weights."""
    metrics, counters = serve_cell.run_serve_cell(0, device="cpu")
    want = baseline["cells"]["serve/qwen2.5-3b/cap2"]
    assert metrics == want["metrics"]
    assert counters == want["counters"]
    assert set(metrics) == set(serve_cell.SERVE_GATED_METRICS)


def test_sweep_cli_never_writes_the_committed_baseline(tmp_path, capsys):
    rc = sweep.main(["--out", str(ROOT / "BENCH_perf.json"),
                     "--device", "cpu"])
    assert rc == 2
    assert "refusing" in capsys.readouterr().err
    assert sweep.DEFAULT_OUT.startswith("build")
