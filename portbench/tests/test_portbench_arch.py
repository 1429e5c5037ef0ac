"""An architecture is found by its ``model_type``. The shared code still
serves qwen2 and dbrx as it did: their parameter counts, and every
reader's reading of the same run (``recorded_readings.json``, read by the
readers before the per-architecture lookups). One that exists only as
added modules (a reader, a reference ``Model``, a parameter count and
small sizes) runs a cell through the harness with no file edited: its
``Model`` is the one that judges, its count the one ``mfu`` reads, and
flash's roofline takes the value head dim it states."""
from __future__ import annotations

import json
import sys
import time
import types

import pytest
import torch

from portbench import run as pr
from portbench.counts import kernels, model, peaks
from portbench.harness import core, trace as tr
from portbench.reference import arch as ref_arch
from portbench.reference import model as ref_model
from portbench.tests import small

CONFIGS = {c["name"]: ref_arch.from_config(json.loads(
    (core.ROOT / c["file"]).read_text())) for c in core.manifest()["configs"]}
MIXES = {w["config"]: core.cell(w["name"]).mix
         for w in core.manifest()["workloads"]}
#: Parameters in total and active a token, of the frozen count.
COUNTS = {"qwen2.5-3b": (3_085_697_024, 3_085_697_024),
          "dbrx-132b": (4_492_197_888, 2_113_929_216)}
READERS = sorted(p.stem for p in (core.BENCH / "metrics").glob("*.py"))
RECORDED = json.loads((core.BENCH / "tests" /
                       "recorded_readings.json").read_text())


def reader(name):
    return core.load_module(core.BENCH / "metrics" / f"{name}.py").read


def ev(name, ts, dur, cat, tid=1, corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def rich_trace() -> tr.Trace:
    """A window of 4 ms holding one step that every reader finds something
    in: the program's phase regions and the harness's spans, flash's
    forward and backward kernels, the expert gather and combine and their
    backwards, GEMMs, a microbatch sum, AdamW, blocking copies and syncs."""
    evs = [ev(tr.WINDOW, 0, 4000, "user_annotation"),
           ev("train.step", 0, 3900, "user_annotation"),
           ev("optim.apply", 3500, 300, "user_annotation"),
           ev("train.forward", 0, 1200, "cpu_op"),
           ev("train.backward", 1200, 1800, "cpu_op"),
           ev("model.recompute", 1300, 600, "cpu_op", tid=2),
           ev("train.accumulate", 3000, 100, "cpu_op"),
           ev("optim.adamw", 3510, 280, "cpu_op"),
           ev("aten::mm", 20, 30, "cpu_op")]
    kernels_at = [  # (name, launch, start, dur, launching thread)
        ("nvjet_gemm_fwd", 10, 40, 200, 1),
        ("(anonymous namespace)::flash_attention_tc_kernel<128>", 250, 260,
         150, 1),
        ("moe_gather_kernel", 420, 430, 150, 1),
        ("moe_combine_kernel<bf16>", 580, 590, 120, 1),
        ("(anonymous namespace)::flash_attention_tc_kernel<128>", 1310,
         1320, 150, 2),
        ("moe_gather_kernel", 1480, 1490, 150, 2),
        ("moe_combine_kernel<bf16>", 1640, 1650, 120, 2),
        ("nvjet_gemm_bwd", 1950, 1960, 300, 2),
        ("dq_tc_kernel<true>", 2270, 2280, 40, 2),
        ("dkdv_tc_kernel", 2330, 2340, 280, 2),
        ("dq_tc_kernel", 2630, 2640, 160, 2),
        ("moe_combine_bwd_kernel<bf16>", 2810, 2820, 100, 2),
        ("moe_combine_kernel<bf16>", 2925, 2930, 60, 2),
        ("add_kernel", 3010, 3020, 40, 1),
        ("adamw_update_kernel<bf16, bf16>", 3520, 3530, 200, 1),
        ("sum_kernel<bf16>", 3740, 3750, 30, 1)]
    for corr, (name, launch, start, dur, tid) in enumerate(kernels_at, 1):
        evs += [ev("cudaLaunchKernel", launch, 1, "cuda_runtime", tid=tid,
                   corr=corr),
                ev(name, start, dur, "kernel", tid=7, corr=corr)]
    evs += [ev("cudaMemcpyAsync", 1100, 1, "cuda_runtime", corr=100),
            ev("Memcpy DtoH (Device -> Pageable)", 1102, 2, "gpu_memcpy",
               tid=7, corr=100),
            ev("cudaStreamSynchronize", 1105, 1, "cuda_runtime", corr=101),
            ev("cudaStreamSynchronize", 2900, 1, "cuda_runtime", tid=2,
               corr=102),
            ev("cudaDeviceSynchronize", 3950, 1, "cuda_runtime", corr=103)]
    return tr.parse(evs)


def rich_run(config: str) -> core.Run:
    """The run every reader reads: 7 steps of the cell's mix in 25 s,
    the rich trace."""
    mix = MIXES[config]
    tokens = 7 * mix["rows"] * mix["seq_len"]
    return core.Run("train", CONFIGS[config], mix, 25.0,
                    {"tokens": tokens, "steps": 7}, rich_trace())


@pytest.mark.parametrize("config", sorted(COUNTS))
def test_the_frozen_parameter_counts(config):
    c = model.param_counts(CONFIGS[config])
    assert (c["total"], c["active"]) == COUNTS[config]


@pytest.mark.parametrize("config", sorted(COUNTS))
@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_as_recorded(name, config):
    assert reader(name)(rich_run(config)) == RECORDED[config][name]


#: The toy architecture's parameter count (not the shared formula's).
TOY_COUNT = {"total": 123_456_789, "active": 12_345_678}


class ToyModel(ref_model.Model):
    """The shared reference, counting the models it builds."""
    built = 0

    def __init__(self, arch, P, G=None, prec="fp32"):
        super().__init__(arch, P, G, prec)
        type(self).built += 1


class ShortToyModel(ToyModel):
    """The shared reference with its last block left out."""

    def __init__(self, arch, P, G=None, prec="fp32"):
        super().__init__(dict(arch, num_layers=arch["num_layers"] - 1), P,
                         G, prec)


def toy_read(c: dict) -> dict:
    """The toy's reader: qwen2's keys, and a value head dim of half the
    query's."""
    return dict(ref_arch.READERS["qwen2"](c),
                v_head_dim=c["hidden_size"] // c["num_attention_heads"] // 2)


def toy(monkeypatch, model_cls):
    """Make ``toy`` a model_type that exists only as added modules, and the
    qwen2.5-3b cell one of it."""
    added = {
        "portbench.reference.arch_toy": {"read": toy_read},
        "portbench.reference.model_toy": {"Model": model_cls},
        "portbench.counts.model_toy": {"param_counts":
                                       lambda arch: dict(TOY_COUNT)},
        "portbench.tests.sizes_toy": {"SIZES": {
            size: small.SIZES[size]["qwen2"] for size in small.SIZES}},
    }
    for name, attrs in added.items():
        mod = types.ModuleType(name)
        mod.__dict__.update(attrs)
        monkeypatch.setitem(sys.modules, name, mod)
    real = core.cell

    def cell(name):
        c = real(name)
        c.config = dict(c.config, model_type="toy")
        return c
    monkeypatch.setattr(core, "cell", cell)
    model_cls.built = 0
    return small.small_cell("qwen2.5-3b.train", "float32")


def run_toy(monkeypatch, model_cls):
    cell, cfg, arch = toy(monkeypatch, model_cls)
    runs = []
    real = core.read_metrics

    def spy(metrics, run):
        runs.append(run)
        return real(metrics, run)
    monkeypatch.setattr(core, "read_metrics", spy)
    out = pr.execute(cell, 2 ** 31 + 91, 0.3, False, torch.device("cpu"),
                     time.perf_counter(), port_cfg=cfg, arch=arch)
    return out, runs[0], arch


def test_an_added_architecture_runs_and_is_judged_by_its_model(
        monkeypatch):
    out, run, arch = run_toy(monkeypatch, ToyModel)
    assert arch["model_type"] == "toy" and arch["v_head_dim"] == 8
    assert out["correct"] is True, out["checks"]
    assert ToyModel.built == run.mix["check_steps"]
    assert model.param_counts(run.arch) == TOY_COUNT
    assert reader("mfu.train")(run) == pytest.approx(
        100 * 6 * TOY_COUNT["active"] * run.counts["tokens"]
        / (peaks.BF16_FLOPS * run.window_s), rel=1e-12)


def test_an_added_model_that_drops_a_block_is_not_correct(monkeypatch):
    out, _, _ = run_toy(monkeypatch, ShortToyModel)
    assert ShortToyModel.built > 0
    assert out["correct"] is False


def test_flash_roofline_takes_the_value_head_dim(monkeypatch):
    _, _, arch = toy(monkeypatch, ToyModel)
    mix = MIXES["qwen2.5-3b"]
    b, s = mix["rows"] // mix["microbatches"], mix["seq_len"]
    flash_s = (2 * 150 + 40 + 280 + 160) / 1e6

    def share(dv):
        shape = (b, s, arch["num_heads"], arch["num_kv_heads"],
                 arch["head_dim"], dv, 2)
        return 100 * (2 * peaks.bound_s(*kernels.flash_forward(*shape),
                                        peaks.BF16_FLOPS)
                      + peaks.bound_s(*kernels.flash_backward(*shape),
                                      peaks.BF16_FLOPS)) / flash_s
    read = reader("kernel.flash_roofline.train")
    assert (arch["head_dim"], arch["v_head_dim"]) == (16, 8)
    assert read(core.Run("train", arch, mix, 1.0, trace=rich_trace())) \
        == pytest.approx(share(8), rel=1e-12)
    del arch["v_head_dim"]
    assert read(core.Run("train", arch, mix, 1.0, trace=rich_trace())) \
        == pytest.approx(share(16), rel=1e-12) != share(8)
