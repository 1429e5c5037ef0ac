"""The readers' arithmetic on synthetic runs and traces: idle share, the
breakdown, AdamW's share, mfu and the kernels' rooflines."""
from __future__ import annotations

import json

import pytest

from portbench.counts import kernels, model, peaks
from portbench.harness import core, trace as tr
from portbench.reference.arch import from_config

QWEN = from_config(json.loads(
    (core.BENCH / "configs" / "qwen2.5-3b.json").read_text()))
DBRX = from_config(json.loads(
    (core.BENCH / "configs" / "dbrx-132b.json").read_text()))
PRETRAIN = json.loads((core.BENCH / "traffic" / "pretrain_4k.json").read_text())
DP2K = json.loads((core.BENCH / "traffic" / "dp_share_2k.json").read_text())


def reader(name):
    return core.load_module(core.BENCH / "metrics" / f"{name}.py").read


def ev(name, ts, dur, cat, tid=1, corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def synthetic() -> tr.Trace:
    """A window [0, 100] us: a step span [0, 90] with an optimizer span
    [50, 80]; kernels [10, 30] (launched at 5), [25, 40] (launched at 20)
    and [60, 70] (launched at 55, inside the optimizer span); the host
    in aten::mm over [40, 58]."""
    return tr.parse([
        ev(tr.WINDOW, 0, 100, "user_annotation"),
        ev("train.step", 0, 90, "user_annotation"),
        ev("optim.apply", 50, 30, "user_annotation"),
        ev("aten::mm", 40, 18, "cpu_op"),
        ev("cudaLaunchKernel", 5, 1, "cuda_runtime", corr=1),
        ev("cudaLaunchKernel", 20, 1, "cuda_runtime", corr=2),
        ev("cudaLaunchKernel", 55, 1, "cuda_runtime", corr=3),
        ev("gemm_a", 10, 20, "kernel", tid=7, corr=1),
        ev("gemm_b", 25, 15, "kernel", tid=8, corr=2),
        ev("adam_kernel", 60, 10, "kernel", tid=7, corr=3),
        ev("outside", 200, 5, "kernel", tid=7, corr=4),
    ])


def test_union_gaps_and_idle_share():
    t = synthetic()
    assert len(t.device) == 3
    assert tr.union_us(t.device, t.start, t.end) == 40.0
    assert [(a, b) for a, b, _ in tr.gaps(t)] == [(0, 10), (40, 60),
                                                  (70, 100)]
    run = core.Run("train", QWEN, PRETRAIN, 1.0, trace=t)
    assert reader("device.idle_share.train")(run) == pytest.approx(60.0)
    assert reader("device.idle_share.train")(
        core.Run("train", QWEN, PRETRAIN, 1.0)) is None


def test_breakdown_labels_gaps_by_the_host():
    b = tr.breakdown(synthetic())
    assert b["device_ops"][0] == ["gemm_a", 20e-6]
    gaps = dict(b["idle_gaps"])
    assert gaps["optim.apply / aten::mm"] == pytest.approx(20e-6)
    assert gaps["train.step / python between ops"] == pytest.approx(40e-6)


def test_adamw_share_counts_what_the_span_launched():
    run = core.Run("train", QWEN, PRETRAIN, 1.0, trace=synthetic())
    assert reader("optim.adamw_share.train")(run) == pytest.approx(
        100 * 10 / 45)


def test_mfu_is_six_n_d_over_the_peak():
    run = core.Run("train", QWEN, PRETRAIN, 10.0, {"tokens": 32768})
    n = model.param_counts(QWEN)["active"]
    assert n == pytest.approx(3.0857e9, rel=1e-3)
    assert reader("mfu.train")(run) == pytest.approx(
        100 * 6 * n * 32768 / (989.4e12 * 10))


def test_dbrx_active_parameters():
    c = model.param_counts(DBRX)
    assert c["total"] == pytest.approx(4.49e9, rel=1e-2)
    assert c["active"] < c["total"]


def flash_trace(n_fwd, n_bwd, fwd_us, bwd_us):
    evs = [ev(tr.WINDOW, 0, 1e9, "user_annotation")]
    t = 1.0
    for i in range(n_fwd):
        evs.append(ev("(anonymous namespace)::flash_attention_tc_kernel<128>",
                      t, fwd_us, "kernel"))
        t += fwd_us + 1
    for i in range(n_bwd):
        for k in ("dq_tc_kernel<true>", "dkdv_tc_kernel", "dq_tc_kernel"):
            evs.append(ev(k, t, bwd_us / 3, "kernel"))
            t += bwd_us / 3 + 1
    return tr.parse(evs)


def test_flash_roofline_from_the_shapes():
    # (p)'s 4 x 512 tokens read 0.422528 ms a forward at a bound of
    # 0.208469 ms (PERF.md, row 7): a share near a half.
    b, s = 1, PRETRAIN["seq_len"]
    fb, fo = kernels.flash_forward(b, s, 16, 2, 128, 128, 2)
    bb, bo = kernels.flash_backward(b, s, 16, 2, 128, 128, 2)
    fwd_s = peaks.bound_s(fb, fo, peaks.BF16_FLOPS)
    bwd_s = peaks.bound_s(bb, bo, peaks.BF16_FLOPS)
    assert fo == 2 * 16 * 256 * s * (s + 1) // 2 and bo == 2.5 * fo
    run = core.Run("train", QWEN, PRETRAIN, 1.0,
                   trace=flash_trace(2, 1, 2 * fwd_s * 1e6, 2 * bwd_s * 1e6))
    assert reader("kernel.flash_roofline.train")(run) == pytest.approx(
        50.0, rel=1e-9)
    none = core.Run("train", QWEN, PRETRAIN, 1.0, trace=flash_trace(0, 0, 1, 1))
    assert reader("kernel.flash_roofline.train")(none) is None


def test_moe_roofline_from_the_shapes():
    t, k, d = 2048, 4, 6144
    slots = 16 * 2048
    bound = sum(n * peaks.bound_s(*fn(t, k, slots, d, 2), peaks.FP32_FLOPS)
                for n, fn in ((2, kernels.moe_gather),
                              (2, kernels.moe_combine),
                              (1, kernels.moe_gather_bwd),
                              (1, kernels.moe_combine_bwd)))
    us = bound * 1e6 / 6 * 2          # six launches, a share of 50 %
    evs = [ev(tr.WINDOW, 0, 1e9, "user_annotation")]
    for i, name in enumerate(["moe_gather_kernel"] * 2
                             + ["moe_combine_kernel<bf16>"] * 3
                             + ["moe_combine_bwd_kernel<bf16>"]):
        evs.append(ev(name, 10 + i * 1e4, us, "kernel"))
    run = core.Run("train", DBRX, DP2K, 1.0, trace=tr.parse(evs))
    assert reader("kernel.moe_roofline.train")(run) == pytest.approx(50.0)
    dropping = dict(DBRX, moe=dict(DBRX["moe"], capacity_factor=1.25))
    assert reader("kernel.moe_roofline.train")(
        core.Run("train", dropping, DP2K, 1.0, trace=tr.parse(evs))) is None


def test_tokens_per_second():
    assert reader("train_tokens_per_s")(
        core.Run("train", QWEN, PRETRAIN, 4.0, {"tokens": 100})) == 25.0
    assert reader("train_tokens_per_s")(
        core.Run("train", QWEN, PRETRAIN, 0.0, {"tokens": 100})) is None


@pytest.mark.parametrize("name", ["train_tokens_per_s", "mfu.train",
                                  "optim.adamw_share.train",
                                  "kernel.flash_roofline.train",
                                  "device.idle_share.train"])
def test_the_expert_cells_readers_read_as_the_dense_ones(name):
    """Each ``<name>.moe`` reader is the ``<name>`` reader: the split gives
    the expert cells their own bound, not another arithmetic."""
    runs = [core.Run("train", DBRX, DP2K, 2.0, {"tokens": 4096},
                     trace=synthetic()),
            core.Run("train", DBRX, DP2K, 1.0, {"tokens": 2048},
                     trace=flash_trace(2, 1, 300.0, 900.0)),
            core.Run("train", DBRX, DP2K, 0.0, {"tokens": 2048})]
    for run in runs:
        assert reader(name + ".moe")(run) == reader(name)(run)
