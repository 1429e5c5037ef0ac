"""Each cell end to end on the card, at a short window: a result line that
is correct, on the device it names. Skips where there is no card (decided
inside the test). On the chip: ``python -m pytest -q -m cuda
portbench/tests/test_portbench_card.py``."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.harness import core


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in core.manifest()[
    "workloads"]])
def test_cell_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          name, "--seed", "2147483990", "--seconds", "3",
                          "--trace", "0"], cwd=core.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
