"""Port parity: tensor-parallel dense compute over ``model`` in the sharded
train step (a gloo world on the CPU).

The reduced qwen3-14b in fp32 on ``data`` 1 x ``model`` 4: q/k norms, an
untied unembedding, 4 query heads over 2 KV heads, so each rank holds one
query head and two ranks read each KV head (``model`` > KV). Three sharded
steps from the reference's own state against the JAX package's
*unsharded* ``train_step`` at ``tests/test_torch_sharded_train.py``'s
bounds (metrics within 1e-5 relative, moments within 1e-4 of their largest
entry, parameters within that plus 5 % of one step), the data ranks'
unequal masks included. Each ``model`` rank computes with its share of
``wq``, ``wo``, the dense MLP, the embedding and the unembedding (each
leaf ``sharding.computed_on_model`` names, gathered over the batch axes
only) and every other leaf whole, and its flash calls get ``H/M`` query
heads and the one KV head they read. Without a world: the KV heads each
rank's query heads read, for head counts, KV counts and ``model`` sizes
where flash's grouping pairs them and where it would not.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
ARCH, MODEL = "qwen3-14b", 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    batches, _ = _batches(512, 3, 7)
    start, metrics, after = _reference_steps(ARCH, None, batches)
    ranks = run_world("torch_dist_workers:sharded_steps", MODEL,
                      backend="gloo", workdir=tmp / "w4",
                      timeout=WORLD_TIMEOUT, python_path=[HERE],
                      kwargs={"cases": [(ARCH, None, start, batches)],
                              "ckpt_dir": None, "data": 1, "model": MODEL})
    return [r[0] for r in ranks], metrics, after


def test_model4_steps_match_unsharded_reference(world):
    ranks, metrics, after = world
    for r in ranks:
        for step, (got, want) in enumerate(zip(r["metrics"], metrics)):
            _hold_metrics(got, want, f"{ARCH} model 4 step {step}")
    cfg = config(ARCH)
    mesh = make_debug_mesh(1, MODEL, devices="cpu")
    _hold_leaves(_assembled(ranks, cfg, mesh), _whole(after, cfg), ARCH)


def test_each_model_rank_computes_with_its_share(world):
    ranks, _, _ = world
    cfg = config(ARCH)
    mesh = make_debug_mesh(1, MODEL, devices="cpu")
    shapes = {k: tuple(v.shape)
              for k, v in flatten(param_shapes(cfg)).items()}
    specs = flatten(sh.param_specs(cfg, mesh, param_shapes(cfg)))
    split = {k for k in shapes if sh.computed_on_model(cfg, k, specs[k])}
    names = {k.rsplit("/", 1)[-1] for k in split}
    assert names == {"wq", "wo", "w_gate", "w_up", "w_down", "embedding",
                     "unembed"}
    for r in ranks:
        got = r["computed"]["leaves"]
        assert set(got) == set(shapes)
        for k, whole in shapes.items():
            want = sh.shard_shape(whole, specs[k], mesh) if k in split \
                else whole
            assert got[k] == want, (k, got[k], want)
            if k in split:
                assert np.prod(want) * MODEL == np.prod(whole), k


def test_flash_gets_the_ranks_heads_and_their_kv_head(world):
    """One query head a rank, over the one KV head it reads: two ranks
    share each KV head, so k and v are cut per rank, never passed whole."""
    ranks, _, _ = world
    cfg = config(ARCH)
    assert MODEL > cfg.num_kv_heads
    layers = cfg.num_layers
    for r in ranks:
        flash = r["computed"]["flash"]
        # Each layer's forward and its recompute under remat.
        assert len(flash) >= layers
        assert set(flash) == {(cfg.num_heads // MODEL, 1)}


@pytest.mark.parametrize("heads,kv,model", [(4, 2, 4), (16, 2, 2), (48, 8, 2),
                                            (40, 8, 8), (48, 8, 3),
                                            (12, 3, 2)])
def test_each_ranks_heads_read_their_kv_heads(monkeypatch, heads, kv, model):
    """``attention._tensor_parallel``: rank r's query heads [r H/M, (r+1)
    H/M) read KV heads [first, first + count), and flash's grouping of
    those (local head j reads j // (H_loc / count)), or the per-head map
    where that grouping would pair them wrongly (48 heads over 3 ranks,
    12 over 2), gives each global head h the KV head h // (H / KV)."""
    import dataclasses

    from repro_torch.distributed import shardlib
    from repro_torch.models import attention
    cfg = dataclasses.replace(config(ARCH), num_heads=heads,
                              num_kv_heads=kv)
    h_loc, g = heads // model, heads // kv
    for r in range(model):
        monkeypatch.setattr(shardlib, "model_block",
                            lambda local, full, r=r: (None, r))
        wq = torch.empty(cfg.d_model, h_loc, 1)
        _, first, count, local = attention._tensor_parallel({"wq": wq}, cfg)
        for j in range(h_loc):
            got = first + (local[j] if local is not None
                           else j // (h_loc // count))
            assert got == (r * h_loc + j) // g, (r, j)
        if heads % kv == 0 and (h_loc % g == 0 or g % h_loc == 0):
            assert local is None, (r, local)
