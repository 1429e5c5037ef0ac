"""Port parity: the paper's cycle model (§III) and area model.

``repro_torch.core.simulator`` and ``core/area_model.py`` are numpy-only
copies of the reference's. Every result must equal the reference's field
for field, and the paper's claims that ``tests/test_simulator.py`` holds
the reference to must hold for the port too.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import area_model as JA  # noqa: E402
from repro.core import simulator as J  # noqa: E402
from repro.core import speculation as JS  # noqa: E402
from repro.mmu import IOTLBParams as JIOTLBParams  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro_torch.core import area_model as TA  # noqa: E402
from repro_torch.core import simulator as T  # noqa: E402
from repro_torch.core import speculation as TS  # noqa: E402
from repro_torch.core.prefetch import analytical_utilization  # noqa: E402
from repro_torch.mmu import IOTLBParams  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402

SIZES = (32, 64, 256, 1024, 4096)
LATENCIES = (1, 13, 100)
HIT_RATES = (0.5, 0.95)


def _iotlb(mod, params):
    return mod.SimConfig("ours-mmu", in_flight=4,
                         prefetch=(JS if mod is J else TS).FixedDepth(4),
                         iotlb=params)


#: Every SimConfig factory, plus an IOTLB config: (name, ref, port).
CONFIGS = {
    "base": (J.SimConfig.base(), T.SimConfig.base()),
    "speculation": (J.SimConfig.speculation(), T.SimConfig.speculation()),
    "scaled": (J.SimConfig.scaled(), T.SimConfig.scaled()),
    "fixed2": (J.SimConfig.fixed(2), T.SimConfig.fixed(2)),
    "logicore": (J.SimConfig.logicore_ip(), T.SimConfig.logicore_ip()),
    "translated": (J.SimConfig.translated_frontend(),
                   T.SimConfig.translated_frontend()),
    "adaptive": (J.SimConfig.adaptive(), T.SimConfig.adaptive()),
    "iotlb": (_iotlb(J, JIOTLBParams()), _iotlb(T, IOTLBParams())),
}


def _fields(result):
    out = dataclasses.asdict(result)
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in out.items()}


@pytest.mark.parametrize("latency", LATENCIES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_simulate_equals_reference_field_for_field(name, latency):
    jcfg, tcfg = CONFIGS[name]
    for size in SIZES:
        for hit in HIT_RATES:
            want = J.simulate(jcfg, latency, size, num_transfers=300,
                              hit_rate=hit)
            got = T.simulate(tcfg, latency, size, num_transfers=300,
                             hit_rate=hit)
            assert type(got).__name__ == "SimResult"
            assert _fields(got) == _fields(want), (name, latency, size, hit)


@pytest.mark.parametrize("payload_ratio", [1.0, 0.254])
def test_simulate_payload_ratio_equals_reference(payload_ratio):
    for name in ("translated", "speculation", "logicore"):
        jcfg, tcfg = CONFIGS[name]
        want = J.simulate(jcfg, 13, 1024, num_transfers=200,
                          payload_ratio=payload_ratio)
        got = T.simulate(tcfg, 13, 1024, num_transfers=200,
                         payload_ratio=payload_ratio)
        assert _fields(got) == _fields(want), name


@pytest.mark.parametrize("channels", [1, 2, 4])
@pytest.mark.parametrize("latency", [13, 100])
def test_multichannel_equals_reference_field_for_field(channels, latency):
    for size in (32, 256):
        kw = dict(num_transfers=200)
        want = J.simulate_multichannel(channels, latency, size, **kw)
        got = T.simulate_multichannel(channels, latency, size, **kw)
        assert type(got).__name__ == "MultiChannelResult"
        assert _fields(got) == _fields(want)
    weights = list(range(1, channels + 1))
    want = J.simulate_multichannel(channels, latency, 64, num_transfers=120,
                                   weights=weights)
    got = T.simulate_multichannel(channels, latency, 64, num_transfers=120,
                                  weights=weights)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("mode", ["shared", "contended"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_equals_reference_field_for_field(shards, mode):
    kw = dict(num_transfers=150, cross_fraction=0.25, interconnect_mode=mode)
    want = J.simulate_sharded(shards, 2, 13, 256, **kw)
    got = T.simulate_sharded(shards, 2, 13, 256, **kw)
    assert _fields(got) == _fields(want)
    if shards > 1:
        assert type(got.sharded).__name__ == "ShardedBusResult"
        assert got.sharded.interconnect_mode == mode


def test_multichannel_tracer_takes_the_ports_tracer():
    jt, tt = JTracer(), Tracer()
    J.simulate_sharded(2, 2, 13, 64, num_transfers=40, cross_fraction=0.5,
                       tracer=jt)
    T.simulate_sharded(2, 2, 13, 64, num_transfers=40, cross_fraction=0.5,
                       tracer=tt)
    want = [dataclasses.astuple(e) for e in jt.events()]
    got = [dataclasses.astuple(e) for e in tt.events()]
    assert got and got == want


def test_table_iv_and_sweep_equal_reference():
    assert T.table_iv() == J.table_iv()
    for name in ("base", "speculation", "logicore"):
        jcfg, tcfg = CONFIGS[name]
        want = [_fields(r) for r in J.utilization_sweep(jcfg, 13)]
        got = [_fields(r) for r in T.utilization_sweep(tcfg, 13)]
        assert got == want
    want = [_fields(r) for r in J.utilization_sweep(
        J.SimConfig.speculation(), 100, sizes=[64, 512], hit_rate=0.5)]
    got = [_fields(r) for r in T.utilization_sweep(
        T.SimConfig.speculation(), 100, sizes=[64, 512], hit_rate=0.5)]
    assert got == want


def test_constants_and_eq1_equal_reference():
    for k in ("BUS_BYTES", "PIPE", "DESC_BYTES", "OURS_DESC_BEATS",
              "NEXT_FIELD_BEAT", "LC_DESC_BEATS", "LC_PROC", "LC_LAUNCH",
              "OURS_I_RF", "LC_I_RF", "R_W", "MEMORY_CONFIGS"):
        assert getattr(T, k) == getattr(J, k), k
    for n in (8, 32, 64, 4096):
        assert T.ideal_utilization(n) == J.ideal_utilization(n)


def test_simulate_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="bus-aligned"):
        T.simulate(T.SimConfig.base(), 13, 60)
    with pytest.raises(ValueError, match="payload_ratio"):
        T.simulate(T.SimConfig.base(), 13, 64, payload_ratio=0.0)
    with pytest.raises(ValueError):
        T.simulate_sharded(0, 2, 13, 64)


@pytest.mark.parametrize("config", sorted(TA.TABLE_II))
def test_area_report_equals_reference(config):
    for d, s in ((4, 0), (4, 4), (24, 24), (7, 3)):
        assert _fields(TA.report(config, d, s)) == _fields(
            JA.report(config, d, s))
        assert TA.area_kge(d, s) == JA.area_kge(d, s)
    assert TA.headline_fpga_savings() == JA.headline_fpga_savings()
    assert TA.TABLE_III == JA.TABLE_III


# ---------------------------------------------------------------------------
# The paper's claims, held against the port (as tests/test_simulator.py
# holds them against the reference)
# ---------------------------------------------------------------------------

def test_eq1_ideal_utilization():
    assert T.ideal_utilization(64) == pytest.approx(64 / 96)
    assert T.ideal_utilization(32) == pytest.approx(0.5)


@pytest.mark.parametrize("size", [32, 64, 128, 256, 512, 1024, 4096])
def test_base_reaches_ideal_in_ideal_memory(size):
    r = T.simulate(T.SimConfig.base(), 1, size)
    assert r.utilization == pytest.approx(T.ideal_utilization(size), rel=0.02)


def test_headline_2_5x_at_64B_ideal_memory():
    ours = T.simulate(T.SimConfig.base(), 1, 64).utilization
    lc = T.simulate(T.SimConfig.logicore_ip(), 1, 64).utilization
    assert ours / lc == pytest.approx(2.5, rel=0.15)


def test_ddr3_speculation_ideal_at_64B_and_headline_ratios():
    spec = T.simulate(T.SimConfig.speculation(), 13, 64).utilization
    assert spec == pytest.approx(T.ideal_utilization(64), rel=0.02)
    lc = T.simulate(T.SimConfig.logicore_ip(), 13, 64).utilization
    base = T.simulate(T.SimConfig.base(), 13, 64).utilization
    assert base / lc == pytest.approx(1.7, rel=0.15)
    assert spec / lc == pytest.approx(3.9, rel=0.25)


def test_deep_scaled_extends_lead_to_3_6x_at_64B():
    ours = T.simulate(T.SimConfig.scaled(), 100, 64).utilization
    lc = T.simulate(T.SimConfig.logicore_ip(), 100, 64).utilization
    assert ours / lc >= 3.6
    assert T.simulate(T.SimConfig.base(), 100, 64).utilization < 0.1


def test_hit_rate_sweep_monotone_and_in_band():
    lc = T.simulate(T.SimConfig.logicore_ip(), 13, 64).utilization
    utils = [T.simulate(T.SimConfig.speculation(), 13, 64,
                        hit_rate=h).utilization
             for h in (0.0, 0.25, 0.5, 0.75, 1.0)]
    assert all(b >= a - 1e-9 for a, b in zip(utils, utils[1:]))
    assert utils[0] / lc >= 1.65
    assert utils[3] / lc >= 2.4


def test_table_iv_ours_exact_and_logicore_within_2_cycles():
    t = T.table_iv()
    assert t["ours"]["i_rf"] == 3 and t["ours"]["r_w"] == 1
    for latency, want in t["paper"]["ours"]["rf_rb"].items():
        assert t["ours"]["rf_rb"][latency] == pytest.approx(want, abs=0.5)
    for latency, want in t["paper"]["logicore"]["rf_rb"].items():
        assert t["logicore"]["rf_rb"][latency] == pytest.approx(want,
                                                                abs=2.5)


def test_latency_improvement_1_66x():
    t = T.table_iv()
    ours = t["ours"]["i_rf"] + t["ours"]["rf_rb"][13]
    lc = t["logicore"]["i_rf"] + t["logicore"]["rf_rb"][13]
    assert lc / ours == pytest.approx(1.66, rel=0.05)


@pytest.mark.parametrize("latency", LATENCIES)
def test_analytical_model_tracks_simulator(latency):
    for size in (64, 256, 1024):
        sim = T.simulate(T.SimConfig.base(), latency, size).utilization
        ana = analytical_utilization(size, latency).utilization
        assert ana == pytest.approx(sim, rel=0.25)


def test_area_model_matches_published_configs():
    assert TA.area_kge(4, 0) == pytest.approx(41.2, rel=0.02)
    assert TA.area_kge(4, 4) == pytest.approx(49.5, rel=0.02)
    assert TA.area_kge(24, 24) == pytest.approx(188.4, rel=0.04)
    s = TA.headline_fpga_savings()
    assert s["lut_savings"] == pytest.approx(0.11, abs=0.01)
    assert s["ff_savings"] == pytest.approx(0.23, abs=0.01)
    r = TA.report("speculation", 4, 4)
    assert r.fmax_ghz == 1.44 and r.rel_err < 0.02
