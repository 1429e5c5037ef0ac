"""Port parity: tensor parallelism over ``model`` for the families the
sharded train step first gathered whole (a gloo world on the CPU): MLA's
heads, deepseek's shared expert and the encoder-decoder.

One world of 4 ranks on ``data`` 2 x ``model`` 2 runs three sharded steps
each of the reduced deepseek-v2-236b (MLA, a dense first layer, then MoE
with a shared expert; expert-parallel at capacity factor 8, its two data
shards holding the same tokens, as ``test_torch_sharded_train.py`` runs
dbrx-132b) and the reduced seamless-m4t-medium (an encoder over stub
``frames``, cross-attention in every decoder block), both in fp32, from
the reference's own state. Every metric, and every leaf after the last
step laid back together from the ranks' blocks, is held against the JAX
package's *unsharded* ``train_step`` at that file's bounds (metrics within
1e-5 relative, moments within 1e-4 of their largest entry, parameters
within that plus 5 % of one step). Each rank computes with its block on
``model`` of exactly the leaves ``sharding.computed_on_model`` names
(MLA's ``q_up``, ``kv_up`` and ``wo``; the shared expert; both stacks'
attention and MLPs, cross-attention's ``wq`` and ``wo``, the vocabulary
leaves) and every other leaf whole; flash gets the rank's heads; and the
parameters it gathers are the gathers over ``data`` alone. Without a
world: the leaves the rule names for each of the ten archs at ``model`` 2.
"""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.world import run_world  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import param_shapes  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

from test_torch_sharded_train import (  # noqa: E402
    WORLD_TIMEOUT,
    _assembled,
    _batches,
    _hold_leaves,
    _hold_metrics,
    _reference_steps,
    _whole,
)
from torch_dist_workers import config  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS, ENC_FRAMES = 3, 12
#: (arch, capacity factor): the world's two cases, in its order.
CASES = [("deepseek-v2-236b", 8.0), ("seamless-m4t-medium", None)]


def _with_frames(batches, d_model, seed):
    """The batches with the encoder's stub input, ``frames`` (B, 12, d)."""
    rng = np.random.default_rng(seed)
    return [dict(b, frames=(rng.standard_normal(
        (b["tokens"].shape[0], ENC_FRAMES, d_model)) * 0.02).astype(
            np.float32)) for b in batches]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_families")
    db, _ = _batches(512, STEPS, 21, same_token_halves=True)
    sb, _ = _batches(512, STEPS, 22)
    sb = _with_frames(sb, config("seamless-m4t-medium").d_model, 23)
    refs = [_reference_steps(arch, cap, b)
            for (arch, cap), b in zip(CASES, (db, sb))]
    ranks = run_world("torch_dist_workers:sharded_steps", 4,
                      backend="gloo", workdir=tmp / "w4",
                      timeout=WORLD_TIMEOUT, python_path=[HERE],
                      kwargs={"cases": [(arch, cap, start, b) for
                                        (arch, cap), b, (start, _, _) in
                                        zip(CASES, (db, sb), refs)],
                              "ckpt_dir": None})
    return ranks, [(m, after) for _, m, after in refs]


def _specs(cfg, mesh):
    shapes = {k: tuple(v.shape)
              for k, v in flatten(param_shapes(cfg)).items()}
    return shapes, flatten(sh.param_specs(cfg, mesh, param_shapes(cfg)))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[a for a, _ in CASES])
def test_steps_match_unsharded_reference(world, case):
    ranks, refs = world
    arch, cap = CASES[case]
    metrics, after = refs[case]
    ranks = [r[case] for r in ranks]
    for r in ranks:
        for step, (got, want) in enumerate(zip(r["metrics"], metrics)):
            _hold_metrics(got, want, f"{arch} step {step}")
    cfg = config(arch, capacity_factor=cap)
    mesh = make_debug_mesh(2, 2, devices="cpu")
    _hold_leaves(_assembled(ranks, cfg, mesh), _whole(after, cfg), arch)


#: The leaves (paths without layer indices) of each case that were
#: gathered whole before MLA, the shared expert and the encoder-decoder
#: ran tensor-parallel: each must now be computed as the rank's block.
NEWLY_SPLIT = {
    "deepseek-v2-236b": {
        "stack/prefix/mixer/q_up", "stack/prefix/mixer/kv_up",
        "stack/prefix/mixer/wo", "stack/slots/mixer/q_up",
        "stack/slots/mixer/kv_up", "stack/slots/mixer/wo",
        "stack/slots/ffn/shared/w_gate", "stack/slots/ffn/shared/w_up",
        "stack/slots/ffn/shared/w_down"},
    "seamless-m4t-medium": {
        "embed/embedding", "embed/unembed",
        "encoder/slots/mixer/wq", "encoder/slots/mixer/wo",
        "encoder/slots/ffn/w_gate", "encoder/slots/ffn/w_up",
        "encoder/slots/ffn/w_down", "stack/slots/mixer/wq",
        "stack/slots/mixer/wo", "stack/slots/cross/wq",
        "stack/slots/cross/wo", "stack/slots/ffn/w_gate",
        "stack/slots/ffn/w_up", "stack/slots/ffn/w_down"},
}


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[a for a, _ in CASES])
def test_each_model_rank_computes_with_its_share(world, case):
    """Each rank computes with its block on ``model`` of exactly the
    leaves ``computed_on_model`` names, every other leaf whole; flash gets
    the rank's half of the heads, over as many KV heads (MHA)."""
    ranks, _ = world
    arch, cap = CASES[case]
    cfg = config(arch, capacity_factor=cap)
    mesh = make_debug_mesh(2, 2, devices="cpu")
    shapes, specs = _specs(cfg, mesh)
    split = {k for k in shapes if sh.computed_on_model(cfg, k, specs[k])}
    assert NEWLY_SPLIT[arch] <= {re.sub(r"/\d+", "", k) for k in split}
    for r in ranks:
        got = r[case]["computed"]["leaves"]
        assert set(got) == set(shapes)
        for k, whole in shapes.items():
            want = whole
            if k in split:
                want = sh.shard_shape(whole, sh.strip(specs[k],
                                                      ("pod", "data")), mesh)
                assert np.prod(want) * 2 == np.prod(whole), k
            assert got[k] == want, (k, got[k], want)
        flash = r[case]["computed"]["flash"]
        assert flash and set(flash) == {(cfg.num_heads // 2,
                                         cfg.num_kv_heads // 2)}


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[a for a, _ in CASES])
def test_params_gathered_over_data_only(world, case):
    """``params_gathered`` counts each leaf's gather over ``data`` and
    nothing over ``model``: every leaf split over ``model`` is computed as
    the rank's block."""
    ranks, _ = world
    arch, cap = CASES[case]
    cfg = config(arch, capacity_factor=cap)
    mesh = make_debug_mesh(2, 2, devices="cpu")
    shapes, specs = _specs(cfg, mesh)
    size = {k: v.element_size() for k, v in
            flatten(param_shapes(cfg)).items()}
    # Gathered over data: the leaf's block on model, less the rank's own.
    over_data = sum(
        (np.prod(sh.shard_shape(whole, sh.strip(specs[k], ("data",)), mesh))
         - np.prod(sh.shard_shape(whole, specs[k], mesh))) * size[k]
        for k, whole in shapes.items())
    whole_bytes = sum(np.prod(w) * size[k] for k, w in shapes.items())
    assert 0 < over_data < whole_bytes / 2
    for r in ranks:
        got = r[case]["traffic"]["params_gathered"]
        assert got == STEPS * over_data, (got, STEPS * over_data)


def _gqa(prefix, bias=False, gated=True):
    mixer = {"wq", "wo"} | ({"bq"} if bias else set())
    ffn = {"w_up", "w_down"} | ({"w_gate"} if gated else set())
    return ({f"{prefix}/mixer/{n}" for n in mixer}
            | {f"{prefix}/ffn/{n}" for n in ffn})


VOCAB, EMBED = {"embed/embedding", "embed/unembed"}, {"embed/embedding"}
#: The leaves (paths without layer indices) ``computed_on_model`` names
#: for each published config on ``model`` 2: every leaf whose spec keeps
#: ``model``.
NAMED = {
    "dbrx-132b": VOCAB | _gqa("stack/slots"),
    "deepseek-v2-236b": VOCAB | {
        f"stack/{s}/mixer/{n}" for s in ("prefix", "slots")
        for n in ("q_up", "kv_up", "wo")} | {
        f"stack/{s}/{n}" for s in ("prefix/ffn", "slots/ffn",
                                   "slots/ffn/shared")
        for n in ("w_gate", "w_up", "w_down")},
    "gemma3-12b": EMBED | _gqa("stack/slots"),
    "jamba-v0.1-52b": VOCAB | _gqa("stack/slots"),
    "mamba2-780m": EMBED,
    "phi-3-vision-4.2b": VOCAB | _gqa("stack/slots"),
    "qwen2.5-3b": EMBED | _gqa("stack/slots", bias=True),
    "qwen3-14b": VOCAB | _gqa("stack/slots"),
    "seamless-m4t-medium": VOCAB | _gqa("stack/slots") | _gqa(
        "encoder/slots") | {"stack/slots/cross/wq", "stack/slots/cross/wo"},
    "starcoder2-15b": VOCAB | _gqa("stack/slots", bias=True, gated=False),
}


@pytest.mark.parametrize("arch", sorted(NAMED))
def test_computed_on_model_names_every_model_split_leaf(arch):
    """The rule's leaves for each published config at ``model`` 2: MLA's,
    the shared expert's and both stacks of the encoder-decoder among them;
    and no leaf whose spec keeps ``model`` is left to be gathered."""
    cfg = get_config(arch)
    mesh = make_debug_mesh(1, 2, devices="cpu")
    specs = flatten(sh.param_specs(cfg, mesh, param_shapes(cfg)))
    named = {re.sub(r"/\d+", "", k) for k, s in specs.items()
             if sh.computed_on_model(cfg, k, s)}
    assert named == NAMED[arch]
    for k, s in specs.items():
        on_model = any("model" in (e if isinstance(e, tuple) else (e,))
                       for e in s)
        assert on_model == sh.computed_on_model(cfg, k, s), (k, s)
