"""The dry run as a count (``repro_torch.launch.dryrun``), held against the
reference on the CPU.

* ``attention_impl="proj_only"``: the port's forward with the core skipped
  matches the reference's (reduced configs of 2 periods, GQA and MLA, the
  reference's weights through ``params_from_jax``, fp32 within 1e-4).
* The meta count is affine in the period count: ``extrapolate`` of the
  P=1 and P=2 counts gives the count at 4 periods exactly, FLOPs and
  bytes, for train, prefill and decode.
* Against XLA: the count's FLOPs of a reduced train and prefill step
  (P=1, ``proj_only``) against the reference's
  ``compile().cost_analysis()["flops"]`` of the same step, lowered with
  ``scan_periods=False`` on one CPU device, within 12 % (measured: count /
  XLA = 0.932 and 1.048 for qwen2.5-3b train and prefill, 0.897 and 1.024
  for deepseek-v2-236b). The gap has two signs: XLA also counts
  elementwise work (norms, rope, softmax, AdamW), which the FLOP counter
  leaves out, and XLA drops the q and k projections that ``proj_only``
  leaves unread, which the eager count keeps.
* The CLI writes an ``ok`` cell with the reference's keys, H100 peaks and
  ``null`` wire bytes, and a cell ``shape_applicable`` rejects as
  ``skipped``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.inputs import prefill_input_specs as jprefill_inputs  # noqa: E402
from repro.launch.inputs import train_input_specs as jtrain_inputs  # noqa: E402
from repro.launch.inputs import train_state_specs_shapes as jstate_shapes  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import param_shapes as jparam_shapes  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import train_step as jtrain_step  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import forward, params_from_jax  # noqa: E402
from repro_torch.roofline import analysis as ra  # noqa: E402

XLA_FLOPS_RTOL = 0.12


def _mesh():
    return make_debug_mesh(1, 1, devices="cpu")


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v2-236b"])
def test_proj_only_forward_matches_the_reference(arch):
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               compute_dtype="float32",
                               attention_impl="proj_only")
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype="float32",
                               attention_impl="proj_only")
    assert tcfg.num_layers - tcfg.first_k_dense == 2   # 2 periods
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tokens = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jaux = jax.jit(lambda p, t: jforward(p, {"tokens": t}, jcfg)[:2])(
        jp, jnp.asarray(tokens))
    tl, taux, _, _ = forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4,
                               atol=1e-4)
    # The core really was skipped: the full attention gives other logits.
    full, _, _, _ = forward(tp, {"tokens": torch.from_numpy(tokens)},
                            dataclasses.replace(tcfg,
                                                attention_impl="blockwise"))
    assert float((full - tl).abs().max()) > 1e-3


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "seamless-m4t-medium"])
def test_count_is_affine_in_the_periods(arch, kind):
    """Prefix layers (deepseek's dense layer 0) and the encoder (seamless)
    included: P=1 and P=2 extrapolate to the count at 4 periods exactly."""
    cfg = get_config(arch, reduced=True)
    shape = ShapeConfig("t", 32, 2, kind)
    counts = []
    for n in (1, 2, 4):
        c = dryrun._with_periods(cfg, n)
        if kind == "decode":
            c = dataclasses.replace(c, attention_impl="blockwise")
        counts.append(dryrun.count(dryrun._step(c, shape, _mesh())[0])[0])
    c1, c2, c4 = counts
    for k in ("flops", "bytes"):
        assert c1[k] > 0 and c2[k] > c1[k]
        assert ra.extrapolate(c1[k], c2[k], 4) == c4[k], k


def _xla_flops(cfg, shape) -> float:
    if shape.kind == "train":
        tcfg = JTrainConfig()
        lowered = jax.jit(lambda s, b: jtrain_step(s, b, cfg, tcfg)).lower(
            jstate_shapes(cfg, tcfg), jtrain_inputs(cfg, shape))
    else:
        lowered = jax.jit(lambda p, b: jforward(p, b, cfg)[0]).lower(
            jparam_shapes(cfg), jprefill_inputs(cfg, shape))
    cost = lowered.compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    return float(cost["flops"])


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-236b"])
def test_count_flops_match_xla(arch, kind):
    jcfg = dryrun._with_periods(jget_config(arch, reduced=True), 1)
    tcfg = dryrun._with_periods(get_config(arch, reduced=True), 1)
    assert not jcfg.scan_periods and jcfg.attention_impl == "proj_only"
    want = _xla_flops(jcfg, JShapeConfig("x", 128, 2, kind))
    got = dryrun.count(dryrun._step(tcfg, ShapeConfig("x", 128, 2, kind),
                                    _mesh())[0])[0]["flops"]
    assert abs(got - want) <= XLA_FLOPS_RTOL * want, (got, want, got / want)


def test_cli_writes_an_ok_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_DRYRUN_DIR", str(tmp_path))
    argv = ["--arch", "qwen3-14b", "--shape", "train_4k", "--mesh", "single"]
    assert dryrun.main(argv) == 0
    assert "[run]" in capsys.readouterr().out
    r = json.loads((tmp_path / "single" / "qwen3-14b__train_4k.json")
                   .read_text())
    assert r["status"] == "ok" and r["chips"] == 256
    for k in dryrun.RESULT_KEYS:
        assert k in r, k
    mem, roof = r["memory"], r["roofline"]
    assert mem["temp_bytes"] is None and mem["peak_per_device_bytes"] is None
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert roof["wire_bytes_per_chip"] is None
    assert roof["collective_s"] is None and roof["collectives"] is None
    assert roof["compute_s"] == roof["hlo_flops_per_chip"] / 989.4e12
    assert roof["memory_s"] == roof["hlo_bytes_per_chip"] / 3.35e12
    assert roof["bottleneck"] in ("compute", "memory")
    ex = r["extrapolation"]
    assert ex["periods"] == 40
    assert ex["p1"]["collectives"] is None
    assert r["raw_cost_analysis"]["flops"] == ra.extrapolate(
        ex["p1"]["flops"], ex["p2"]["flops"], 40)
    core_f, _ = ra.core_totals(get_config("qwen3-14b"),
                               dryrun.SHAPES["train_4k"])
    assert roof["hlo_flops_per_chip"] == pytest.approx(
        r["raw_cost_analysis"]["flops"] + core_f / 256)
    assert roof["model_flops"] == ra.model_flops(get_config("qwen3-14b"),
                                                 dryrun.SHAPES["train_4k"])
    # A second run reads the cached cell.
    assert dryrun.main(argv) == 0
    assert "[cached]" in capsys.readouterr().out


def test_cli_writes_a_skipped_cell(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DRYRUN_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "qwen3-14b", "--shape", "long_500k",
                        "--mesh", "multipod"]) == 0
    r = json.loads((tmp_path / "multipod" / "qwen3-14b__long_500k.json")
                   .read_text())
    assert r["status"] == "skipped" and "sub-quadratic" in r["reason"]
