"""The control at a size a test run holds (8 layers of qwen2.5-3b: fp8's
error builds up over depth): the reference computed at fp8 in the
program's place must come out not correct against each cell's own limits
(on the chip it is read at the cells' sizes, PERF.md §2)."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import run as pr
from portbench.harness import core
from portbench.tests.small import small_cell


@pytest.mark.parametrize("name", [w["name"] for w in core.manifest()[
    "workloads"]])
def test_control_is_not_correct(name):
    cell, cfg, arch = small_cell(name, "bfloat16", "deep")
    out = pr.execute(cell, 2 ** 31 + 5, 2.0, False, torch.device("cpu"),
                     time.perf_counter(), control=True, port_cfg=cfg,
                     arch=arch)
    assert out["control"] is True
    assert out["correct"] is False, out["checks"]
    assert set(out["checks"]) == set(core.limits(name))
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
