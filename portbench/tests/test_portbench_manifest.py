"""The manifest against the benchmark's contract: names, units, keys, and
every file a cell, configuration or metric names found by that name."""
from __future__ import annotations

import json
import re

import pytest

from portbench.harness import core

MAN = core.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection",
          "head", "expansion", "per_tok", "top_k")


def test_top_level_keys_and_command():
    assert set(MAN) == TOP
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def _entries():
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        for e in MAN[group]:
            yield group, keys, e


@pytest.mark.parametrize("group,keys,entry",
                         list(_entries()),
                         ids=lambda x: x["name"] if isinstance(x, dict)
                         else None)
def test_entry_keys_names_units(group, keys, entry):
    assert set(entry) <= keys
    assert NAME.match(entry["name"]), entry["name"]
    for k in ("why", "layer", "source"):
        if k in entry:
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k] \
                and "\t" not in entry[k]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
    if group == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if group == "per_layer":
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_cells_on_one_chip_with_their_files():
    used = set()
    for w in MAN["workloads"]:
        assert w["chips"] == 1
        cell = core.cell(w["name"])
        used.add(w["config"])
        assert (core.BENCH / "kinds" / f"{cell.kind}.py").exists()
        assert core.limits(w["name"]), f"no limits for {w['name']}"
        for m in cell.per_layer + cell.end_to_end:
            if m["name"] != "setup_s":
                assert (core.BENCH / "metrics" / f"{m['name']}.py").exists()
    assert used == {c["name"] for c in MAN["configs"]}


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    for w in MAN["workloads"]:
        cell = core.cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])


def test_setup_bound_and_sources():
    setup = next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    path = core.ROOT / entry["file"]
    assert path.parts[len(core.ROOT.parts)] == "portbench"
    cfg = json.loads(path.read_text())
    assert cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key)
        assert not any(w in key for w in WIDTHS) and \
            not key.endswith(("_dim", "_rank", "_size")), key


def test_per_layer_layers_and_moves():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", ()):
            assert w in {x["name"] for x in MAN["workloads"]}
    for m in MAN["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
