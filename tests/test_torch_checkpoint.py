"""Port parity: the checkpointer against the reference's
``repro.checkpoint``.

The port's checkpoints keep the reference's layout (``step_%09d/``,
``shard_<host>.npz``, ``manifest.json``, ``COMMIT`` last): a round trip
restores every leaf exactly, bf16 included; uncommitted step directories
are ignored; ``keep`` bounds what stays. A nested dict of fp32 and bf16
leaves written by either package restores in the other bit for bit, with
the same manifest.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402
from repro_torch.train import TrainState  # noqa: E402


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.randn(4, generator=g).to(torch.bfloat16),
                       "list": [torch.randn((2, 2), generator=g),
                                torch.tensor(7, dtype=torch.int32)]}}


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    ck.save(10, tree, blocking=True, extra={"iterator": {"step": 10}})
    got, extra = ck.restore(10, tree)
    assert extra["iterator"]["step"] == 10
    assert got["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["nested"]["b"], tree["nested"]["b"])
    assert torch.equal(got["nested"]["list"][0], tree["nested"]["list"][0])
    assert int(got["nested"]["list"][1]) == 7
    d = tmp_path / "step_000000010"
    assert sorted(os.listdir(d)) == ["COMMIT", "manifest.json",
                                     "shard_0.npz"]
    manifest = json.loads((d / "manifest.json").read_text())
    dtypes = {a["name"]: a["dtype"] for a in manifest["arrays"]}
    assert dtypes == {"a": "float32", "nested/b": "bfloat16",
                      "nested/list/0": "float32", "nested/list/1": "int32"}


def test_checkpoint_of_a_train_state(tmp_path):
    """NamedTuple fields name their leaves as the reference's do; the
    restored state is a TrainState again, None residuals included."""
    p = {"w": torch.ones(3)}
    state = TrainState(p, AdamWState(torch.tensor(4, dtype=torch.int32),
                                     {"w": torch.full((3,), 2.0)},
                                     {"w": torch.full((3,), 3.0)}), None)
    ck = Checkpointer(str(tmp_path))
    ck.save(4, state, blocking=True)
    names = {a["name"] for a in json.loads(
        (tmp_path / "step_000000004" / "manifest.json").read_text())["arrays"]}
    assert names == {".params/w", ".opt/.step", ".opt/.m/w", ".opt/.v/w"}
    got, _ = ck.restore(4, state)
    assert isinstance(got, TrainState) and got.residuals is None
    assert int(got.opt.step) == 4 and torch.equal(got.opt.v["w"],
                                                  state.opt.v["w"])


def test_checkpoint_ignores_uncommitted(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.zeros(2)}
    ck.save(1, tree, blocking=True)
    os.makedirs(tmp_path / "step_000000002")      # a torn write
    os.makedirs(tmp_path / "step_000000003.tmp0")
    assert ck.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        ck.restore(2, tree)


def test_checkpoint_gc_keeps_last_k(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)                           # async, serialised
    ck.wait()
    assert ck.committed_steps() == [3, 4]
    ck.save(4, {"a": torch.ones(2)}, blocking=True)   # a step saved twice
    assert sorted(os.listdir(tmp_path)) == ["step_000000003",
                                            "step_000000004"]


def test_checkpoint_saves_what_the_tree_held_at_save_time(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.zeros(1000)}
    ck.save(1, tree)
    tree["a"].add_(5)                 # the next step updates in place
    ck.wait()
    got, _ = ck.restore(1, tree)
    assert float(got["a"].abs().max()) == 0.0


def _jtree(tree):
    def conv(x):
        x = x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
        return jnp.asarray(x)
    out = {"a": conv(tree["a"]),
           "nested": {"b": conv(tree["nested"]["b"]).astype(jnp.bfloat16),
                      "list": [conv(x) for x in tree["nested"]["list"]]}}
    return out


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree()
    Checkpointer(str(tmp_path)).save(3, tree, blocking=True,
                                     extra={"iterator": {"step": 3}})
    like = _jtree(tree)
    got, extra = JCheckpointer(str(tmp_path)).restore(3, like)
    assert extra == {"iterator": {"step": 3}}
    assert got["nested"]["b"].dtype == jnp.bfloat16
    for a, b in ((got["a"], tree["a"]), (got["nested"]["list"][0],
                                         tree["nested"]["list"][0])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        np.asarray(got["nested"]["b"]).astype(np.float32),
        tree["nested"]["b"].float().numpy())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree()
    JCheckpointer(str(tmp_path)).save(5, _jtree(tree), blocking=True)
    mine = json.loads((tmp_path / "step_000000005" / "manifest.json")
                      .read_text())
    got, _ = Checkpointer(str(tmp_path)).restore(5, tree)
    assert got["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["nested"]["b"], tree["nested"]["b"])
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["nested"]["list"][0], tree["nested"]["list"][0])
    # The same manifest records either way (the time aside).
    Checkpointer(str(tmp_path / "port")).save(5, tree, blocking=True)
    port = json.loads((tmp_path / "port" / "step_000000005"
                       / "manifest.json").read_text())
    key = lambda a: a["name"]  # noqa: E731
    assert sorted(port["arrays"], key=key) == sorted(mine["arrays"], key=key)
