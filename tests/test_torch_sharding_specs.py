"""Port parity: the sharding specs (``repro_torch.distributed.sharding``)
and meshes (``repro_torch.launch.mesh``) against the reference's, for all
10 archs on meshes of 16x16, 2x16x16 and 2x2 (the reference's spec
functions read only ``mesh.shape``, so its side gets a stand-in with that
mapping).

The slots mapping: the reference stacks a pattern slot's blocks over
periods, so a block leaf at ``stack/slots/j/<leaf>`` has a leading periods
axis and its spec leads with ``None``; the port keeps one block per
(slot, period) at ``stack/slots/j/i/<leaf>``, of the unstacked shape. So
for every period i the port's spec is the reference's without that
leading ``None``: ``ref == (None,) + port``. Decode caches are stacked
over periods in both packages and compare as they are.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch.inputs import decode_state_shapes as jdecode_shapes  # noqa: E402
from repro.launch.inputs import train_input_specs as jtrain_inputs  # noqa: E402
from repro.models import param_shapes as jparam_shapes  # noqa: E402
from repro.optim import AdamWState as JAdamWState  # noqa: E402
from repro.train.step import TrainState as JTrainState  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.inputs import (  # noqa: E402
    decode_state_shapes,
    train_input_specs,
    train_state_specs_shapes,
)
from repro_torch.launch.mesh import (  # noqa: E402
    make_debug_mesh,
    make_production_mesh,
)
from repro_torch.models import param_shapes  # noqa: E402
from repro_torch.train import TrainConfig  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

MESHES = {"16x16": lambda: make_production_mesh(),
          "2x16x16": lambda: make_production_mesh(multi_pod=True),
          "2x2": lambda: make_debug_mesh(2, 2, devices="cpu")}


class _FakeMesh:
    def __init__(self, mesh):
        self.shape = dict(mesh.shape)


def _part(k) -> str:
    if isinstance(k, jax.tree_util.DictKey):
        return str(k.key)
    if isinstance(k, jax.tree_util.SequenceKey):
        return str(k.idx)
    if isinstance(k, jax.tree_util.GetAttrKey):
        return f".{k.name}"
    return str(k)


def _jflat(tree, is_leaf=None) -> dict:
    """{path: leaf} of a reference tree, paths named as the port's."""
    return {"/".join(_part(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _jspecs(tree) -> dict:
    return {p: tuple(s) for p, s in
            _jflat(tree, is_leaf=lambda x: isinstance(x, JP)).items()}


def _unstacked(path: str):
    """(reference path, stacked) of a port path: the period index after
    ``slots/j`` dropped."""
    parts = path.split("/")
    for i, part in enumerate(parts[:-2]):
        if part == "slots":
            return "/".join(parts[:i + 2] + parts[i + 3:]), True
    return path, False


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    return param_shapes(get_config(arch)), jparam_shapes(jget_config(arch))


def _hold_param_specs(port_specs: dict, ref_specs: dict, port_shapes: dict,
                      ref_shapes: dict) -> None:
    seen = set()
    for path, spec in port_specs.items():
        ref_path, stacked = _unstacked(path)
        want = ref_specs[ref_path]
        got = tuple(spec)
        shape = tuple(port_shapes[path].shape)
        ref_shape = tuple(ref_shapes[ref_path].shape)
        if stacked:
            assert want == (None,) + got, (path, want, got)
            assert ref_shape[1:] == shape, (path, ref_shape, shape)
        else:
            assert want == got, (path, want, got)
            assert ref_shape == shape, (path, ref_shape, shape)
        seen.add(ref_path)
    assert seen == set(ref_specs)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", jlist_archs())
def test_param_specs_match_the_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]()
    fake = _FakeMesh(mesh)
    cfg, jcfg = get_config(arch), jget_config(arch)
    tshapes, jshapes = _shapes(arch)
    pshapes, rshapes = flatten(tshapes), _jflat(jshapes)
    _hold_param_specs(flatten(sh.param_specs(cfg, mesh, tshapes)),
                      _jspecs(jsh.param_specs(jcfg, fake, jshapes)),
                      pshapes, rshapes)
    _hold_param_specs(flatten(sh.serving_param_specs(cfg, mesh, tshapes)),
                      _jspecs(jsh.serving_param_specs(jcfg, fake, jshapes)),
                      pshapes, rshapes)

    # Per-chip parameter bytes: the port's shards against the bytes the
    # reference's specs give its stacked leaves.
    axes = dict(mesh.shape)
    want = 0
    rspecs = _jspecs(jsh.param_specs(jcfg, fake, jshapes))
    for path, leaf in rshapes.items():
        spec = rspecs[path] + (None,) * (len(leaf.shape) - len(rspecs[path]))
        block = [-(-d // (1 if e is None else math.prod(
            axes[a] for a in (e if isinstance(e, tuple) else (e,)))))
            for d, e in zip(leaf.shape, spec)]
        want += math.prod(block) * np.dtype(leaf.dtype).itemsize
    got = sh.per_device_bytes(tshapes, sh.param_specs(cfg, mesh, tshapes),
                              mesh)
    assert got == want
    total = sum(x.numel() * x.element_size() for x in pshapes.values())
    assert got * math.prod(axes.values()) >= total


@pytest.mark.parametrize("arch", jlist_archs())
def test_param_specs_divide_every_sharded_dim(arch):
    """Every arch x mesh: the specs build, divisible dims shard, the rest
    replicate (the property of tests/test_sharding.py, on the port)."""
    cfg = get_config(arch)
    shapes = param_shapes(cfg)
    for mesh in (make_production_mesh(), make_production_mesh(multi_pod=True)):
        specs = flatten(sh.param_specs(cfg, mesh, shapes))
        for path, leaf in flatten(shapes).items():
            spec = specs[path]
            assert len(spec) <= leaf.ndim, (arch, path, spec, leaf.shape)
            for i, entry in enumerate(spec):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                size = int(np.prod([mesh.shape[a] for a in axes]))
                assert leaf.shape[i] % size == 0, \
                    (arch, path, spec, leaf.shape)
                block = sh.shard_shape(tuple(leaf.shape), spec, mesh)
                assert block[i] * size == leaf.shape[i]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", jlist_archs())
def test_state_batch_and_decode_specs_match_the_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]()
    fake = _FakeMesh(mesh)
    cfg, jcfg = get_config(arch), jget_config(arch)
    tshapes, jshapes = _shapes(arch)

    # Train state: params and both moments by the slots mapping; step P().
    state = train_state_specs_shapes(cfg, TrainConfig())
    jstate = JTrainState(params=jshapes, opt=JAdamWState(
        step=jax.ShapeDtypeStruct((), np.int32), m=jshapes, v=jshapes),
        residuals=None)
    tspec = sh.train_state_specs(cfg, mesh, state)
    jspec = jsh.train_state_specs(jcfg, fake, jstate)
    assert tspec.residuals is None and jspec.residuals is None
    assert tuple(tspec.opt.step) == tuple(jspec.opt.step) == ()
    for t, j in ((tspec.params, jspec.params), (tspec.opt.m, jspec.opt.m),
                 (tspec.opt.v, jspec.opt.v)):
        _hold_param_specs(flatten(t), _jspecs(j), flatten(tshapes),
                          _jflat(jshapes))

    # Batches, at every shape.
    for name in SHAPES:
        shape, jshape = SHAPES[name], JSHAPES[name]
        assert sh.batch_axis(mesh, shape.global_batch) == \
            jsh.batch_axis(fake, jshape.global_batch)
        got = {k: tuple(v) for k, v in sh.train_batch_specs(
            mesh, shape.global_batch, train_input_specs(cfg, shape)).items()}
        want = {k: tuple(v) for k, v in jsh.train_batch_specs(
            fake, jshape.global_batch, jtrain_inputs(jcfg, jshape)).items()}
        assert got == want

    # Decode states: batch-sharded (decode_32k), and sequence-sharded where
    # the batch does not divide (long_500k, batch 1), with and without
    # kv_seq_axis.
    for name in ("decode_32k", "long_500k"):
        shape, jshape = SHAPES[name], JSHAPES[name]
        state, _ = decode_state_shapes(cfg, shape)
        jstate_d, _ = jdecode_shapes(jcfg, jshape)
        assert sorted(flatten(state)) == sorted(_jflat(jstate_d))
        for ax in (None, "model"):
            got = {p: tuple(s) for p, s in flatten(sh.decode_state_specs(
                cfg, mesh, state, shape.global_batch,
                kv_seq_axis=ax)).items()}
            want = _jspecs(jsh.decode_state_specs(
                jcfg, fake, jstate_d, jshape.global_batch, kv_seq_axis=ax))
            assert got == want, (name, ax)

    assert sh.activation_rules(mesh) == jsh.activation_rules(fake)
    assert sh.fsdp_axes(mesh) == jsh.fsdp_axes(fake)


def test_batch_axis_selection():
    class M1:
        shape = {"pod": 2, "data": 16, "model": 16}

    class M2:
        shape = {"data": 16, "model": 16}
    for m in (M1(), M2()):
        for b in (1, 2, 16, 32, 128, 256):
            assert sh.batch_axis(m, b) == jsh.batch_axis(m, b)
    assert sh.batch_axis(M1(), 256) == ("pod", "data")
    assert sh.batch_axis(M1(), 2) == "pod"
    assert sh.batch_axis(M2(), 1) is None


def test_meshes():
    single, multi = make_production_mesh(), \
        make_production_mesh(multi_pod=True)
    assert dict(single.shape) == {"data": 16, "model": 16}
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16}
    assert single.devices.size == 256 and multi.devices.size == 512
    assert {d.type for d in multi.devices.flat} == {"meta"}
    one = make_debug_mesh(1, 1, devices="cpu")
    assert dict(one.shape) == {"data": 1, "model": 1}
    assert list(one.devices.flat) == [torch.device("cpu")]
    pod = make_debug_mesh(2, 2, pod=2, devices=["cpu"] * 8)
    assert dict(pod.shape) == {"pod": 2, "data": 2, "model": 2}
    with pytest.raises(ValueError):
        make_debug_mesh(2, 2, devices=["cpu"] * 3)
    assert sh.shard_shape((256, 4096, 8), sh.P(("pod", "data"), "model"),
                          multi) == (8, 256, 8)
    assert sh.shard_shape((7,), sh.P("model"), single) == (1,)
