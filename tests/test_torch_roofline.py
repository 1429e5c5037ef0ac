"""Port parity: the roofline (``repro_torch.roofline.analysis``) against the
reference's ``repro.roofline.analysis`` on the CPU.

Everything that reads only a config is held exactly equal for every arch
and shape: ``param_counts``, ``model_flops``, ``attention_core`` at
``attn`` and ``local``, ``core_totals`` and ``extrapolate``. The HLO
collective parser gives the reference's bytes per kind on
``tests/test_roofline.py``'s sample. The terms, the bottleneck and the MFU
are recomputed from the H100 constants, and no TPU peak is left in the
port.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.roofline import analysis as jra  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.roofline import analysis as ra  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

HLO_SAMPLE = """
HloModule test
  %p = f32[16,128]{1,0} parameter(0)
  %ar = f32[16,128]{1,0} all-reduce(%p), replica_groups={}
  %ag = bf16[32,256]{1,0} all-gather(%x), dimensions={0}
  %rs = f32[8,128]{1,0} reduce-scatter(%p), dimensions={0}
  %a2a = bf16[4,64]{1,0} all-to-all(%y), dimensions={0}
  %cp = u8[1024]{0} collective-permute(%z)
  %t = (f32[4,4]{1,0}, s32[8]{0}) all-reduce(%a, %b), replica_groups={}
  %dot = f32[16,16]{1,0} dot(%p, %p)
"""


@pytest.mark.parametrize("shape", sorted(JSHAPES))
@pytest.mark.parametrize("arch", jlist_archs())
def test_config_functions_equal_the_reference(arch, shape):
    assert list_archs() == jlist_archs() and sorted(SHAPES) == sorted(JSHAPES)
    t, j = get_config(arch), jget_config(arch)
    ts, js = SHAPES[shape], JSHAPES[shape]
    assert t.param_counts() == j.param_counts()
    assert ra.model_flops(t, ts) == jra.model_flops(j, js)
    for kind in ("attn", "local"):
        assert ra.attention_core(t, ts, kind) == jra.attention_core(j, js,
                                                                     kind)
    assert ra.core_totals(t, ts) == jra.core_totals(j, js)
    periods = (t.num_layers - t.first_k_dense) // len(t.block_pattern)
    for f1, f2 in ((1.5e12, 2.75e12), (7.0, 7.0), (3.0, 11.0)):
        assert ra.extrapolate(f1, f2, periods) == \
            jra.extrapolate(f1, f2, periods)


def test_collective_parser_matches_the_reference():
    got, want = ra.collective_bytes(HLO_SAMPLE), jra.collective_bytes(
        HLO_SAMPLE)
    assert got == want
    assert got["all-reduce"] == (16 * 128 * 4 + 4 * 4 * 4 + 8 * 4) * 2.0
    assert got["all-gather"] == 32 * 256 * 2
    assert got["collective-permute"] == 1024
    assert ra._shape_bytes("(bf16[2,3], f32[4], token[])") == \
        jra._shape_bytes("(bf16[2,3], f32[4], token[])") == 28
    assert sum(ra.collective_bytes("%d = f32[128,128] dot(%a, %b)\n")
               .values()) == 0


def test_build_matches_the_reference_with_hlo_text():
    cfg, jcfg = get_config("qwen3-14b"), jget_config("qwen3-14b")
    cost = {"flops": 3.5e14, "bytes accessed": 8.25e11}
    got = ra.build("qwen3-14b", SHAPES["train_4k"], "single", 256, cfg,
                   cost, HLO_SAMPLE, 1.5e9)
    want = jra.build("qwen3-14b", JSHAPES["train_4k"], "single", 256, jcfg,
                     cost, HLO_SAMPLE, 1.5e9)
    g, w = got.to_dict(), want.to_dict()
    assert sorted(g) == sorted(w)
    for k in ("arch", "shape", "mesh", "chips", "hlo_flops_per_chip",
              "hlo_bytes_per_chip", "wire_bytes_per_chip", "collectives",
              "model_flops", "bytes_per_chip_hbm", "useful_flops_ratio"):
        assert g[k] == w[k], k


def test_h100_peaks():
    assert ra.PEAK_FLOPS == 989.4e12
    assert ra.PEAK_FLOPS_FP32 == 67e12
    assert ra.HBM_BW == 3.35e12
    assert ra.LINK_BW * ra.LINKS_PER_CHIP == 450e9   # NVLink 4, a direction


def test_roofline_terms_bottleneck_and_mfu_on_h100_peaks():
    r = ra.Roofline(arch="a", shape="s", mesh="m", chips=256,
                    hlo_flops_per_chip=ra.PEAK_FLOPS,
                    hlo_bytes_per_chip=ra.HBM_BW,
                    wire_bytes_per_chip=2 * ra.LINK_BW * ra.LINKS_PER_CHIP,
                    collectives={}, model_flops=ra.PEAK_FLOPS * 256 * 0.5,
                    bytes_per_chip_hbm=1e9)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(2.0)
    assert r.bottleneck == "collective"
    assert r.step_time_s == pytest.approx(2.0)
    assert r.mfu == pytest.approx(0.25)   # 0.5 useful / 2 s step
    assert r.useful_flops_ratio == pytest.approx(0.5)


def test_roofline_without_wire_bytes_leaves_the_collective_uncounted():
    r = ra.Roofline(arch="a", shape="s", mesh="1x1", chips=1,
                    hlo_flops_per_chip=2 * ra.PEAK_FLOPS,
                    hlo_bytes_per_chip=ra.HBM_BW, wire_bytes_per_chip=None,
                    collectives=None, model_flops=ra.PEAK_FLOPS,
                    bytes_per_chip_hbm=None)
    d = r.to_dict()
    assert d["collective_s"] is None and d["wire_bytes_per_chip"] is None
    assert d["bytes_per_chip_hbm"] is None
    assert r.bottleneck == "compute" and r.step_time_s == pytest.approx(2.0)
    assert r.mfu == pytest.approx(0.5)
    mem = ra.Roofline(arch="a", shape="s", mesh="1x1", chips=1,
                      hlo_flops_per_chip=1.0, hlo_bytes_per_chip=ra.HBM_BW,
                      wire_bytes_per_chip=None, collectives=None,
                      model_flops=1.0, bytes_per_chip_hbm=None)
    assert mem.bottleneck == "memory" and mem.step_time_s == pytest.approx(1)
    assert ra.build("qwen3-14b", SHAPES["train_4k"], "1x1", 1,
                    get_config("qwen3-14b"), {"flops": 1.0}, None,
                    None).collective_s is None


def test_no_tpu_peak_in_the_port():
    tpu = (jra.PEAK_FLOPS, jra.HBM_BW, jra.LINK_BW)
    assert (197e12, 819e9) == tpu[:2]
    for v in (ra.PEAK_FLOPS, ra.PEAK_FLOPS_FP32, ra.HBM_BW, ra.LINK_BW):
        assert v not in tpu
    pat = re.compile(r"\b(197e12|819e9|197 TFLOP|819 GB/s|v5e)\b")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0)}" for f in files
            for m in pat.finditer(f.read_text())]
    assert hits == []
