"""The readers of the train step's regions on synthetic traces: the idle
time by phase, the microbatch sums' share, launches and host syncs a step,
None where the program has no regions, and the ``.moe`` twins."""
from __future__ import annotations

import json

import pytest

from portbench.harness import core, regions, trace as tr
from portbench.reference.arch import from_config

QWEN = from_config(json.loads(
    (core.BENCH / "configs" / "qwen2.5-3b.json").read_text()))
PRETRAIN = json.loads((core.BENCH / "traffic" / "pretrain_4k.json").read_text())

NEW = ("train.forward_idle_share.train", "train.backward_idle_share.train",
       "train.recompute_idle_share.train", "train.accumulate_share.train",
       "train.launches_per_step.train", "train.host_syncs_per_step.train",
       "train.launches_per_step.train.moe",
       "train.host_syncs_per_step.train.moe")


def reader(name):
    return core.load_module(core.BENCH / "metrics" / f"{name}.py").read


def ev(name, ts, dur, cat, tid=1, corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def phase_trace(cat="cpu_op", syncs=True, steps=1) -> tr.Trace:
    """A window [0, 200] us holding one step: the forward [0, 40] and the
    backward [40, 100] on the main thread (1), a recompute [50, 70] on
    autograd's thread (2), a sum [100, 110], AdamW [120, 180] (inside the
    harness's ``optim.apply``). Kernels [10, 30] (launched in the forward),
    [45, 55] and [60, 80] (by autograd's thread, the second in the
    recompute), [100, 108] (the sum), [130, 170] (AdamW), [190, 195]
    (outside every phase); a blocking copy [85, 86] in the backward and
    its sync at 86, another sync at 65; the harness's synchronise at 196.
    ``steps`` > 1 adds AdamW regions of empty steps after the first."""
    evs = [
        ev(tr.WINDOW, 0, 200, "user_annotation"),
        ev("train.step", 0, 190, "user_annotation"),
        ev("optim.apply", 118, 64, "user_annotation"),
        ev("train.forward", 0, 40, cat),
        ev("train.backward", 40, 60, cat),
        ev("model.recompute", 50, 20, cat, tid=2),
        ev("train.accumulate", 100, 10, cat),
        ev("optim.adamw", 120, 60, cat),
        ev("aten::mm", 2, 3, "cpu_op"),
        ev("cudaLaunchKernel", 5, 1, "cuda_runtime", corr=1),
        ev("cudaLaunchKernel", 42, 1, "cuda_runtime", tid=2, corr=2),
        ev("cudaLaunchKernel", 58, 1, "cuda_runtime", tid=2, corr=3),
        ev("cudaMemcpyAsync", 84, 1, "cuda_runtime", tid=2, corr=4),
        ev("cudaLaunchKernel", 101, 1, "cuda_runtime", corr=5),
        ev("cudaLaunchKernel", 125, 1, "cuda_runtime", corr=6),
        ev("cudaLaunchKernel", 185, 1, "cuda_runtime", corr=7),
        ev("gemm_fwd", 10, 20, "kernel", tid=7, corr=1),
        ev("gemm_bwd", 45, 10, "kernel", tid=7, corr=2),
        ev("gemm_recompute", 60, 20, "kernel", tid=7, corr=3),
        ev("Memcpy DtoH (Device -> Pageable)", 85, 1, "gpu_memcpy", tid=7,
           corr=4),
        ev("add_kernel", 100, 8, "kernel", tid=7, corr=5),
        ev("adam_kernel", 130, 40, "kernel", tid=7, corr=6),
        ev("loss_kernel", 190, 5, "kernel", tid=7, corr=7),
    ]
    if syncs:
        evs += [ev("cudaStreamSynchronize", 65, 1, "cuda_runtime", tid=2,
                   corr=8),
                ev("cudaStreamSynchronize", 86, 1, "cuda_runtime", tid=2,
                   corr=9),
                ev("cudaDeviceSynchronize", 196, 1, "cuda_runtime",
                   corr=10)]
    for i in range(1, steps):
        evs.append(ev("optim.adamw", 180 + 2 * i, 1, cat))
    return tr.parse(evs)


def run_of(t) -> core.Run:
    return core.Run("train", QWEN, PRETRAIN, 1.0, trace=t)


@pytest.mark.parametrize("cat", ["cpu_op", "user_annotation"])
def test_each_reader_on_a_hand_made_trace(cat):
    run = run_of(phase_trace(cat))
    # Idle: [0, 10], [30, 45], [55, 60], [80, 85], [86, 100], [108, 130],
    # [170, 190], [195, 200] of a window of 200.
    assert reader("train.forward_idle_share.train")(run) == \
        pytest.approx(100 * 20 / 200)
    assert reader("train.backward_idle_share.train")(run) == \
        pytest.approx(100 * 29 / 200)
    assert reader("train.recompute_idle_share.train")(run) == \
        pytest.approx(100 * 5 / 200)
    assert reader("train.accumulate_share.train")(run) == \
        pytest.approx(100 * 8 / 104)
    assert reader("train.launches_per_step.train")(run) == 5.0
    assert reader("train.host_syncs_per_step.train")(run) == 2.0


def test_per_step_counts_divide_by_the_adamw_regions():
    run = run_of(phase_trace(steps=2))
    assert regions.steps(run.trace) == 2
    assert reader("train.launches_per_step.train")(run) == 2.5
    assert reader("train.host_syncs_per_step.train")(run) == 1.0


def test_none_without_regions_and_no_syncs_is_zero():
    harness_only = tr.parse([
        ev(tr.WINDOW, 0, 100, "user_annotation"),
        ev("train.step", 0, 90, "user_annotation"),
        ev("optim.apply", 50, 30, "user_annotation"),
        ev("cudaLaunchKernel", 55, 1, "cuda_runtime", corr=1),
        ev("cudaStreamSynchronize", 60, 1, "cuda_runtime", corr=2),
        ev("adam_kernel", 60, 10, "kernel", tid=7, corr=1),
    ])
    for name in NEW:
        assert reader(name)(run_of(harness_only)) is None, name
        assert reader(name)(core.Run("train", QWEN, PRETRAIN, 1.0)) is None
    assert reader("train.host_syncs_per_step.train")(
        run_of(phase_trace(syncs=False))) == 0.0


def idle_split(t: tr.Trace) -> dict:
    """The window's idle microseconds by phase, ``outside`` every phase, and
    in all (``idle``); the recompute's is part of the backward's."""
    gaps = regions.idle(t)
    out = {name: regions.overlap_us(gaps, regions.intervals(t, name))
           for name in regions.PHASES + (regions.RECOMPUTE,)}
    out["idle"] = sum(e - s for s, e in gaps)
    out["outside"] = out["idle"] - regions.overlap_us(
        gaps, regions.intervals(t, *regions.PHASES))
    return out


def test_the_phases_idle_time_adds_up_to_the_idle_share():
    t = phase_trace()
    run = run_of(t)
    window = t.end - t.start
    split = idle_split(t)
    assert split == pytest.approx({
        "train.forward": 20, "train.backward": 29, "train.accumulate": 2,
        "optim.adamw": 20, "model.recompute": 5, "outside": 25,
        "idle": 96})
    total = reader("train.forward_idle_share.train")(run) \
        + reader("train.backward_idle_share.train")(run) \
        + 100 * (split["train.accumulate"] + split["optim.adamw"]
                 + split["outside"]) / window
    assert total == pytest.approx(reader("device.idle_share.train")(run))
    assert reader("train.recompute_idle_share.train")(run) <= \
        reader("train.backward_idle_share.train")(run)


@pytest.mark.parametrize("name", [n for n in NEW if n.endswith(".moe")])
def test_moe_twins_read_as_their_twin(name):
    run = run_of(phase_trace(steps=3))
    assert reader(name)(run) == reader(name[:-len(".moe")])(run)
    assert reader(name)(run) is not None


def test_intervals_merge_and_clip_to_the_window():
    t = tr.parse([
        ev(tr.WINDOW, 10, 100, "user_annotation"),
        ev("train.forward", 0, 20, "cpu_op"),
        ev("train.forward", 15, 10, "cpu_op", tid=2),
        ev("train.forward", 30, 5, "cpu_op"),
        ev("train.forward", 105, 20, "cpu_op"),
        ev("train.forward", 120, 5, "cpu_op"),
    ])
    assert regions.intervals(t, "train.forward") == [(10, 25), (30, 35),
                                                     (105, 110)]
    assert regions.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
