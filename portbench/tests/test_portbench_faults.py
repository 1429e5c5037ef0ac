"""Whole runs of the harness at small widths on the CPU, past its look for
a card: a sound run comes out correct with the result line's keys, and
the timed path broken underneath comes out not correct, once for each
fault a training cell can have (a step that returns its state unchanged;
half the batch left out, the mean taken over the rest). One chip, so no
exchange between chips to leave out."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import run as pr
from portbench.harness import core
from portbench.tests.small import small_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def run_small(name: str):
    """A run of the small cell in fp32 compute."""
    cell, cfg, arch = small_cell(name, "float32")
    return pr.execute(cell, SEED, 0.3, False, CPU, time.perf_counter(),
                      port_cfg=cfg, arch=arch)


@pytest.mark.parametrize("name", [w["name"] for w in core.manifest()[
    "workloads"]])
def test_sound_run_is_correct_with_the_result_keys(name):
    out = run_small(name)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in
                                   core.cell(name).end_to_end}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == set(core.limits(name))


TRAIN = [w["name"] for w in core.manifest()["workloads"]
         if core.cell(w["name"]).kind == "train"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_the_state_unchanged(name, monkeypatch):
    import repro_torch.train as rt

    def make(cfg, tcfg):
        def step(state, batch):
            _, m = rt.grads_and_metrics(state.params, batch, cfg,
                                        tcfg.microbatches)
            return state, m
        return step
    monkeypatch.setattr(rt, "make_train_step", make)
    out = run_small(name)
    assert out["correct"] is False
    assert out["checks"]["change"]["value"] > out["checks"]["change"]["limit"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out(name, monkeypatch):
    import repro_torch.train as rt
    real = rt.make_train_step

    def make(cfg, tcfg):
        step = real(cfg, tcfg)

        def half(state, batch):
            return step(state, {k: v[:v.shape[0] // 2]
                                for k, v in batch.items()})
        return half
    monkeypatch.setattr(rt, "make_train_step", make)
    out = run_small(name)
    assert out["correct"] is False


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = pr.main(["--workload", "qwen2.5-3b.train", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_nothing_but_the_benchmark_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's own
    files: no program to run, no result, a code other than 0."""
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "qwen2.5-3b.train", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    json.dumps(out.stderr)
