"""Port parity: the sharded train step on process meshes (gloo worlds on
the CPU), its checkpoints and the elastic restore.

* The sharded ``train_step`` on ``data`` 2 x ``model`` 2 (each rank its
  blocks of every ``TrainState`` leaf under ``train_state_specs``, its rows
  of the batch) for the reduced qwen2.5-3b and dbrx-132b in fp32, three
  steps from the reference's own state: every metric, and every leaf after
  the last step laid back together from the ranks' blocks, against the
  JAX package's *unsharded* ``train_step`` (its own sharded case fails in
  the reference) within ``tests/test_torch_train.py``'s bounds: metrics
  within 1e-5 relative, moments within 1e-4 of their largest entry,
  parameters within that plus 5 % of one step (the key bias's gradient is
  rounding noise, which AdamW turns into steps of up to lr). The qwen
  batches give the two data ranks unequal loss masks: the loss is a token
  mean over the whole batch, not a mean of the ranks' means. dbrx-132b runs
  expert-parallel at capacity factor 8 (no drops), its two data shards
  holding the same tokens (with other labels and masks): its auxiliary
  loss is a mean of per-shard losses, as in the reference's ``shard_map``
  form, which equals the whole batch's only when the shards route alike.
  Both run tensor-parallel over ``model`` (wq, wo, the dense MLP and the
  vocabulary leaves as each rank's block, gradients reduce-scattered onto
  their blocks): each rank computes with exactly its share, and flash
  gets its rank's heads.
* Microbatches (C1): on ``data`` 2 at ``microbatches`` 2, the same unequal
  masks, three steps against the JAX package's unsharded ``train_step`` at
  ``microbatches`` 2, within the same bounds; 3 microbatches of a batch of
  4 over 2 ranks raise ``ValueError``. Without a world: each rank's rows
  of each microbatch are the reference's (block d of slice i) for 2 and 4
  ranks and 2 and 4 microbatches.
* The EF-int8 step on ``pod`` 2: loss, gradient norm, parameters and each
  pod's residual against the reference's formula recomputed in one JAX
  process (each pod's gradient of its own rows, ``flat = g + r`` in blocks
  of 256, the mean of what was sent, AdamW): the metrics against the JAX
  package's within 1e-5, every leaf (parameters, moments, both pods'
  residuals) against the same formula in the port bit for bit.
* Elastic: the 2x2 world saves its state (rank 0 writes, the reference's
  layout); ``survive_shrink`` restores it onto ``data`` 1 x ``model`` 2
  after a first mesh that fails, every leaf bit-equal and every block of
  the new mesh's shape; the next step's loss matches the reference's
  fourth step. A checkpoint the JAX package's ``Checkpointer`` wrote
  restores through the port's ``reshard_checkpoint``, bit-equal.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.optim.compress import _dequantize, _quantize  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import grads_and_metrics as jgrads  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import train_step as jtrain_step  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.world import run_world  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import param_shapes  # noqa: E402
from repro_torch.models import train_state_from_jax  # noqa: E402
from repro_torch.train import TrainConfig, state_shapes  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

from torch_dist_workers import config  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD_TIMEOUT = 150
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=6, weight_decay=0.1,
            grad_clip=1.0)


def _jconfig(arch, cap=None):
    jc = dataclasses.replace(jget_config(arch, reduced=True),
                             compute_dtype="float32")
    if cap is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=cap))
    return jc


def _batches(vocab, n, seed, *, same_token_halves=False, b=4, s=32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n + 1):
        tokens = rng.integers(1, vocab, (b, s)).astype(np.int32)
        labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
        mask = np.ones((b, s), np.float32)
        # Data rank 0's rows keep a quarter of their tokens, rank 1's all.
        mask[: b // 2, s // 4:] = 0
        if same_token_halves:
            tokens[b // 2:] = tokens[: b // 2]
        out.append({"tokens": tokens, "labels": labels, "loss_mask": mask})
    return out[:n], out[n]


def _np_state(jstate):
    return jax.tree.map(np.asarray, jstate)


def _whole(tree_np, tc):
    return flatten(train_state_from_jax(tree_np, tc, "cpu"))


def _assembled(ranks, cfg, mesh, tcfg=TrainConfig(), key="blocks"):
    """Every leaf laid back together from the ranks' blocks."""
    from repro_torch.train import state_block_specs
    specs = flatten(state_block_specs(cfg, mesh, tcfg))
    shapes = flatten(state_shapes(cfg, tcfg))
    return {k: sh.assemble([r[key][k] for r in ranks], tuple(shapes[k].shape),
                           specs[k], mesh)
            for k in ranks[0][key]}


def _hold_leaves(got, want, label):
    for k, w in want.items():
        slack = 0.05 * OCFG["lr"] if k.startswith(".params") else 1e-12
        err = float((got[k].double() - w.double()).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + slack, (label, k, err)


def _hold_metrics(got, want, label):
    assert set(got) == set(want), label
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5,
                                   err_msg=f"{label} {k}")


def _reference_steps(arch, cap, batches, extra=None, microbatches=1):
    jc = _jconfig(arch, cap)
    jt = JTrainConfig(optimizer=joptim.AdamWConfig(**OCFG),
                      microbatches=microbatches)
    jstate = jinit_state(jinit(jax.random.PRNGKey(0), jc), jt)
    start = _np_state(jstate)
    metrics = []
    for b in batches + ([extra] if extra is not None else []):
        jstate, m = jtrain_step(jstate, {k: jnp.asarray(v)
                                         for k, v in b.items()}, jc, jt)
        metrics.append({k: float(v) for k, v in m.items()})
        if len(metrics) == len(batches):
            after = _np_state(jstate)
    return start, metrics, after


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    qb, q_next = _batches(512, 3, 0)
    db, _ = _batches(512, 3, 1, same_token_halves=True)
    q_start, q_metrics, q_after = _reference_steps("qwen2.5-3b", None, qb,
                                                   extra=q_next)
    d_start, d_metrics, d_after = _reference_steps("dbrx-132b", 8.0, db)
    _, mb_metrics, mb_after = _reference_steps("qwen2.5-3b", None, qb,
                                               microbatches=2)
    ckpt = tmp / "ckpt"
    four = run_world("torch_dist_workers:sharded_steps", 4, backend="gloo",
                     workdir=tmp / "w4", timeout=WORLD_TIMEOUT,
                     python_path=[HERE],
                     kwargs={"cases": [("qwen2.5-3b", None, q_start, qb),
                                       ("dbrx-132b", 8.0, d_start, db)],
                             "ckpt_dir": str(ckpt)})
    # A checkpoint of the reference's start state, written by the JAX
    # package's Checkpointer in the port's tree layout.
    jax_ckpt = tmp / "jax_ckpt"
    tc = config("qwen2.5-3b")
    port_tree = jax.tree.map(
        lambda t: t.numpy(),
        train_state_from_jax(q_start, tc, "cpu"))
    JCheckpointer(str(jax_ckpt)).save(2, port_tree, blocking=True)
    cb, _ = _batches(512, 2, 2)
    two = run_world("torch_dist_workers:two_rank_steps", 2,
                    backend="gloo", workdir=tmp / "w2",
                    timeout=WORLD_TIMEOUT, python_path=[HERE],
                    kwargs={"arch": "qwen2.5-3b", "state_np": q_start,
                            "batches": cb, "ckpt_dir": str(ckpt),
                            "jax_ckpt_dir": str(jax_ckpt),
                            "step_batch": q_next, "mb_batches": qb})
    return {"four": four, "two": two, "ckpt": ckpt, "q_start": q_start,
            "q": (q_metrics, q_after), "d": (d_metrics, d_after), "cb": cb,
            "mb": (mb_metrics, mb_after)}


@pytest.mark.parametrize("case", ["qwen2.5-3b", "dbrx-132b"])
def test_sharded_steps_match_unsharded_reference(worlds, case):
    i, cap = (0, None) if case == "qwen2.5-3b" else (1, 8.0)
    metrics, after = worlds["q" if i == 0 else "d"]
    ranks = [r[i] for r in worlds["four"]]
    for r in ranks:
        for step, (got, want) in enumerate(zip(r["metrics"], metrics)):
            _hold_metrics(got, want, f"{case} step {step}")
    cfg = config(case, capacity_factor=cap)
    mesh = make_debug_mesh(2, 2, devices="cpu")
    _hold_leaves(_assembled(ranks, cfg, mesh), _whole(after, cfg), case)


def test_sharded_blocks_have_the_specs_shapes(worlds):
    cfg = config("qwen2.5-3b")
    mesh = make_debug_mesh(2, 2, devices="cpu")
    shapes = flatten(state_shapes(cfg, TrainConfig()))
    specs = flatten(sh.train_state_specs(cfg, mesh,
                                         state_shapes(cfg, TrainConfig())))
    split = 0
    for r in worlds["four"]:
        for k, blk in r[0]["blocks"].items():
            want = sh.shard_shape(tuple(shapes[k].shape), specs[k], mesh)
            assert tuple(blk.shape) == want, k
            split += want != tuple(shapes[k].shape)
    assert split > 0


@pytest.mark.parametrize("case", ["qwen2.5-3b", "dbrx-132b"])
def test_model_ranks_compute_with_their_share(worlds, case):
    """Tensor parallelism on the 2x2 mesh: each ``model`` rank computes
    with its block on ``model`` of the leaves ``computed_on_model`` names
    (wq, wo, the dense MLP, the vocabulary leaves; dbrx-132b's experts),
    every other leaf whole, and flash gets its rank's query heads and the
    KV head they read."""
    i, cap = (0, None) if case == "qwen2.5-3b" else (1, 8.0)
    cfg = config(case, capacity_factor=cap)
    mesh = make_debug_mesh(2, 2, devices="cpu")
    shapes = flatten(param_shapes(cfg))
    specs = flatten(sh.param_specs(cfg, mesh, param_shapes(cfg)))
    split = set()
    for r in worlds["four"]:
        got = r[i]["computed"]["leaves"]
        assert set(got) == set(shapes)
        for k, shape in shapes.items():
            whole = tuple(shape.shape)
            if sh.computed_on_model(cfg, k, specs[k]):
                want = sh.shard_shape(whole, sh.strip(specs[k],
                                                      ("pod", "data")), mesh)
                assert want != whole, k
                split.add(k.rsplit("/", 1)[-1])
            else:
                want = whole
            assert got[k] == want, (k, got[k], want)
        heads = cfg.num_heads // 2
        assert r[i]["computed"]["flash"] and all(
            q == heads and kv == cfg.num_kv_heads // 2
            for q, kv in r[i]["computed"]["flash"])
    want = {"wq", "wo", "w_gate", "w_up", "w_down", "embedding"}
    want |= {"unembed"} if not cfg.tie_embeddings else {"bq"}
    assert want <= split, split


def test_microbatches_match_unsharded_reference(worlds):
    """C1: on ``data`` 2 at ``microbatches`` 2, with the data ranks'
    unequal masks, three steps against the JAX package's unsharded step at
    ``microbatches`` 2: the reference's microbatch i is rows [2i, 2i + 2)
    of the global batch, of which each data rank computes its row."""
    metrics, after = worlds["mb"]
    cfg = config("qwen2.5-3b")
    mesh = make_debug_mesh(2, 1, devices="cpu")
    ranks = [r["microbatched"] for r in worlds["two"]]
    for r in ranks:
        for step, (got, want) in enumerate(zip(r["metrics"], metrics)):
            _hold_metrics(got, want, f"microbatches 2 step {step}")
        assert "into 3 microbatches over 2 ranks" in r["refused"]
    _hold_leaves(_assembled(ranks, cfg, mesh), _whole(after, cfg),
                 "microbatches 2")


class _Gathers:
    """``shardlib.all_gather`` over ranks whose rows of ``tokens`` are
    consecutive blocks of ``rows``: every rank's block."""

    def __init__(self, rows, ranks):
        self.blocks = list(rows.chunk(ranks))

    def __call__(self, t, axes, mesh):
        return [b.clone() for b in self.blocks]


class _Positions:
    """A mesh of ``ranks`` positions along the batch axes, at ``index``."""

    def __init__(self, ranks, index):
        self.ranks, self.i = ranks, index

    def size(self, axes):
        return self.ranks

    def index(self, axes):
        return self.i


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("n", [2, 4])
def test_microbatch_rows_are_the_references(monkeypatch, ranks, n):
    """Each rank's rows of each microbatch: the reference splits the global
    batch into n contiguous slices (``_split_microbatches``) and GSPMD
    gives rank d block d of each; the port gathers the ranks' rows and
    cuts them so (``train.step._microbatches``)."""
    from repro_torch.distributed import shardlib
    from repro_torch.train import step as step_mod
    rows = 2 * n * ranks
    glob = torch.arange(rows)
    monkeypatch.setattr(shardlib, "all_gather", _Gathers(glob, ranks))
    want = [s.chunk(ranks) for s in glob.chunk(n)]
    for d in range(ranks):
        local = {"tokens": glob.chunk(ranks)[d]}
        got = step_mod._microbatches(local, n, _Positions(ranks, d),
                                     ("data",))
        assert [g["tokens"].tolist() for g in got] == \
            [w[d].tolist() for w in want]
        assert step_mod.microbatch_rows(rows, n, ranks, d) == [
            (int(w[d][0]), int(w[d][-1]) + 1) for w in want]
    with pytest.raises(ValueError, match="does not split"):
        step_mod.microbatch_rows(rows + ranks, n, ranks, 0)


def test_loss_is_a_token_mean_across_ranks_with_unequal_masks(worlds):
    """The qwen batches' data ranks hold 1/4 and all of their tokens: the
    sharded loss is the whole batch's token mean (held above against the
    reference), and a mean of the two ranks' own means is far from it."""
    from repro_torch.models import loss_fn
    qb, _ = _batches(512, 3, 0)
    cfg = config("qwen2.5-3b")
    state = train_state_from_jax(worlds["q_start"], cfg, "cpu")
    b = {k: torch.as_tensor(v) for k, v in qb[0].items()}
    whole, _ = loss_fn(state.params, b, cfg)
    halves = [loss_fn(state.params, {k: v[i:i + 2] for k, v in b.items()},
                      cfg)[0] for i in (0, 2)]
    got = worlds["four"][0][0]["metrics"][0]["loss"]
    np.testing.assert_allclose(got, float(whole), rtol=1e-5)
    assert abs(float(sum(halves)) / 2 - float(whole)) > 1e-3


def _ef_reference(worlds, framework):
    """Two EF-int8 steps recomputed in one process, as the reference's
    formula reads: each pod's gradient of its own rows, ``flat = g + r``
    in blocks of 256, the mean of what was sent, AdamW (no clipping)."""
    ocfg = dict(OCFG, grad_clip=0.0)
    cfg = config("qwen2.5-3b")
    halves = [[{k: v[2 * p:2 * p + 2] for k, v in b.items()} for p in (0, 1)]
              for b in worlds["cb"]]
    metrics = []
    if framework == "jax":
        jc = _jconfig("qwen2.5-3b")
        params = jinit(jax.random.PRNGKey(0), jc)
        opt = joptim.init(params)
        res = [jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                            params) for _ in range(2)]

        def formula(g, r):
            flat = g.astype(jnp.float32).reshape(-1) + r.reshape(-1)
            pad = jnp.pad(flat, (0, (-flat.size) % 256))
            sent = _dequantize(*_quantize(pad))[:flat.size]
            return sent.reshape(g.shape), (flat - sent).reshape(g.shape)

        for pair in halves:
            sent, losses = [], []
            for p, half in enumerate(pair):
                g, m = jgrads(params, {k: jnp.asarray(v)
                                       for k, v in half.items()}, jc, 1)
                leaves, tdef = jax.tree.flatten(g)
                out = [formula(a, r) for a, r in
                       zip(leaves, jax.tree.leaves(res[p]))]
                sent.append(tdef.unflatten([o[0] for o in out]))
                res[p] = tdef.unflatten([o[1] for o in out])
                losses.append(float(m["loss"]))
            reduced = jax.tree.map(lambda a, c: (a + c) / 2.0, *sent)
            params, opt, om = joptim.apply(joptim.AdamWConfig(**ocfg),
                                           params, reduced, opt)
            metrics.append({"loss": sum(losses) / 2,
                            "grad_norm": float(om["grad_norm"])})
        return metrics, None
    from repro_torch import optim
    from repro_torch.optim.compress import _dequantize as dq
    from repro_torch.optim.compress import _quantize as qz
    from repro_torch.train import grads_and_metrics
    state = train_state_from_jax(worlds["q_start"], cfg, "cpu")
    params, opt = state.params, state.opt
    res = [{k: torch.zeros_like(v) for k, v in flatten(params).items()}
           for _ in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # as the ranks run
    try:
        for pair in halves:
            sent = []
            for p, half in enumerate(pair):
                g, _ = grads_and_metrics(params, {
                    k: torch.as_tensor(v) for k, v in half.items()}, cfg, 1)
                s = {}
                for k, gk in flatten(g).items():
                    flat = gk.float().reshape(-1) + res[p][k].reshape(-1)
                    n = flat.numel()
                    pad = torch.nn.functional.pad(flat, (0, (-n) % 256))
                    s[k] = dq(*qz(pad))[:n]
                    res[p][k] = (flat - s[k]).reshape(gk.shape)
                    s[k] = s[k].reshape(gk.shape)
                sent.append(s)
            reduced = {k: (sent[0][k] + sent[1][k]) / torch.tensor(2.0)
                       for k in sent[0]}
            params, opt, _ = optim.apply(
                optim.AdamWConfig(**ocfg), params,
                sh.map_with_path(lambda k, _: reduced[k], params), opt)
    finally:
        torch.set_num_threads(threads)
    return metrics, (params, opt, res)


def test_ef_int8_step_matches_reference_formula(worlds):
    """Metrics against the JAX package's formula within 1e-5; every leaf
    against the same formula in the port in one process, bit for bit: the
    ranks' gradients of their rows are that process's, and any ulp before
    the int8 rounding could move a block's element by a quantum."""
    cfg = config("qwen2.5-3b")
    tcfg = TrainConfig(compress_pod_axis="pod")
    mesh = make_debug_mesh(1, 1, pod=2, devices="cpu")
    ranks = [r["compressed"] for r in worlds["two"]]
    want_metrics, _ = _ef_reference(worlds, "jax")
    for r in ranks:
        for step, (got, want) in enumerate(zip(r["metrics"], want_metrics)):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=f"step {step} {k}")
    _, (params, opt, res) = _ef_reference(worlds, "torch")
    got = _assembled(ranks, cfg, mesh, tcfg)
    for name, tree in (("params", params), ("opt/.m", opt.m),
                       ("opt/.v", opt.v)):
        for k, w in flatten(tree).items():
            assert torch.equal(got[f".{name}/{k}"], w), (name, k)
    # Each pod keeps its own residual of the whole leaf.
    for k in res[0]:
        pods = got[f".residuals/{k}"]
        for p in range(2):
            assert torch.equal(pods[p], res[p][k]), (p, k)
    assert worlds["two"][0]["res_shapes"] == {
        k: tuple(v.shape) for k, v in res[0].items()}


def test_elastic_restore_onto_a_smaller_mesh(worlds):
    cfg = config("qwen2.5-3b")
    saved, extra = Checkpointer(str(worlds["ckpt"])).restore(
        3, state_shapes(cfg, TrainConfig()), device="cpu")
    assert extra == {"case": "qwen2.5-3b"}
    ranks = [r["elastic"] for r in worlds["two"]]
    assert ranks[0]["attempts"] == [0, 1]
    mesh = make_debug_mesh(1, 2, devices="cpu")
    got = _assembled(ranks, cfg, mesh)
    specs = flatten(sh.train_state_specs(cfg, mesh,
                                         state_shapes(cfg, TrainConfig())))
    for k, w in flatten(saved).items():
        assert torch.equal(got[k], w), k
        assert tuple(ranks[0]["blocks"][k].shape) == sh.shard_shape(
            tuple(w.shape), specs[k], mesh), k
    # The fourth step after the restore, against the reference's.
    q_metrics, _ = worlds["q"]
    _hold_metrics(ranks[0]["next"], q_metrics[3], "step after restore")


def test_jax_checkpoint_reshards_through_the_port(worlds):
    cfg = config("qwen2.5-3b")
    mesh = make_debug_mesh(1, 2, devices="cpu")
    got = _assembled(worlds["two"], cfg, mesh, key="from_jax")
    want = _whole(worlds["q_start"], cfg)
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
