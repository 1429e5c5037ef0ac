"""Port parity: the collectives on process meshes (gloo worlds on the CPU).

* The EF-int8 all-reduce (``optim.compress``) over a ``pod`` group of 2:
  every leaf's reduced gradient and new residual bit for bit against the
  reference's ``compress_allreduce_leaf`` under ``shard_map`` on a pod
  axis of 2 (two host devices, in a subprocess); the tree form equal to
  the leaf form; the wire bytes of both forms; the 200-step
  error-feedback property of the reference's ``test_substrate``.
* ``make_process_mesh``: it refuses a world of another size and a backend
  the world does not run; group positions follow mesh order.
* ``shardlib.reduce_scatter`` in a world of 4, over ``data`` and over
  ``("pod", "data")`` on three meshes, the FSDP dim on 0, 1 and 2: equal
  bit for bit to all-reduce then ``take_block``; and the sharded step's
  reduction in the EF-int8 layout (``train.step._onto_block``).
* Expert-parallel ``moe_ffn`` (``_moe_ffn_ep``) on the reduced dbrx-132b
  in fp32: on ``data`` 2 x ``model`` 2 with capacity factor 8 (no drops:
  per-shard capacity differs from the whole batch's) against the
  reference's meshless ``moe_ffn`` on the same weights within 2e-4 (the
  reference's own EP test's bound, ``tests/test_sharding.py``); on
  ``data`` 1 x ``model`` 2 at capacity factor 1 (tokens dropped), where
  the plans are the one-process plan: the drop share and the auxiliary
  loss equal, the output and the gradients of x, the router and each
  rank's experts against the one-process port's within 1e-5 of their
  largest entry (fp32 sums in another order); the reduced model's
  gradients under remat equal whether the backward (and so the
  recompute) runs inside the mesh's context, after it, or on another
  thread, as autograd's thread for the card runs it.
* The launcher's four multi-host flags under ``torch.distributed.run``
  on gloo, a world of 2 (``pod`` 2, EF-int8 across it), the reduced
  config cut to 1 layer (``--layers``).

Every world rendezvouses through a file store under ``tmp_path``, each
rank joins with a timeout, and ``run_world`` kills every rank left when
one fails or the deadline passes.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.moe import init_moe as jinit_moe  # noqa: E402
from repro.models.moe import moe_ffn as jmoe_ffn  # noqa: E402
from repro_torch.distributed.world import run_world  # noqa: E402
from repro_torch.optim import compression_ratio  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD_TIMEOUT = 120

SHAPES = [(3,), (300,), (16, 40), (2, 256), (5, 7, 11)]


def _world(tmp_path, name, target, n, **kwargs):
    return run_world(f"torch_dist_workers:{target}", n, backend="gloo",
                     workdir=tmp_path / name, kwargs=kwargs,
                     timeout=WORLD_TIMEOUT, python_path=[HERE])


# ---------------------------------------------------------------------------
# EF-int8 and meshes: one world of 2 on a pod axis
# ---------------------------------------------------------------------------

def _ef_inputs():
    rng = np.random.default_rng(0)
    grads = [[rng.standard_normal(s).astype(np.float32) * (1 + r)
              for s in SHAPES] for r in range(2)]
    residuals = [[rng.standard_normal(s).astype(np.float32) * 1e-2
                  for s in SHAPES] for r in range(2)]
    return grads, residuals


def _jax_ef(tmp_path, grads, residuals):
    """The reference's leaf function under shard_map over 2 host devices."""
    inp = tmp_path / "ef_in.npz"
    out = tmp_path / "ef_out.npz"
    np.savez(inp, **{f"g{i}": np.stack([grads[0][i], grads[1][i]])
                     for i in range(len(SHAPES))},
             **{f"r{i}": np.stack([residuals[0][i], residuals[1][i]])
                for i in range(len(SHAPES))})
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        import jax, numpy as np
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P
        from repro.optim.compress import compress_allreduce_leaf
        mesh = jax.make_mesh((2,), ("pod",))
        fn = shard_map(
            lambda g, r: tuple(x[None] for x in compress_allreduce_leaf(
                g[0], r[0], "pod")),
            mesh=mesh, in_specs=(P("pod"), P("pod")),
            out_specs=(P("pod"), P("pod")), check_rep=False)
        z = np.load({str(inp)!r})
        res = {{}}
        for i in range({len(SHAPES)}):
            red, new_r = fn(z[f"g{{i}}"], z[f"r{{i}}"])
            res[f"red{{i}}"], res[f"res{{i}}"] = np.asarray(red), np.asarray(new_r)
        np.savez({str(out)!r}, **res)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def ef_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ef")
    grads, residuals = _ef_inputs()
    converge = np.random.default_rng(1).standard_normal(512).astype(
        np.float32)
    ranks = _world(tmp, "world", "ef_and_mesh", 2, grads=grads,
                   residuals=residuals, converge=converge)
    return ranks, _jax_ef(tmp, grads, residuals), converge


def test_ef_int8_leaf_matches_reference_shard_map(ef_world):
    ranks, want, _ = ef_world
    for rank, out in enumerate(ranks):
        for i, (red, res) in enumerate(out["leaf"]):
            # Bit-equal: at two ranks the rank-order sum is the psum.
            np.testing.assert_array_equal(red.numpy(), want[f"red{i}"][rank],
                                          err_msg=f"rank {rank} leaf {i}")
            np.testing.assert_array_equal(res.numpy(), want[f"res{i}"][rank],
                                          err_msg=f"rank {rank} leaf {i}")


def test_ef_int8_tree_equals_leaves_and_counts_wire_bytes(ef_world):
    ranks, _, _ = ef_world
    for out in ranks:
        red, res = out["tree"]
        for i, (lr, lres) in enumerate(out["leaf"]):
            assert torch.equal(red[str(i)], lr)
            assert torch.equal(res[str(i)], lres)
        n = sum(int(np.prod(s)) for s in SHAPES)
        padded = sum(-(-int(np.prod(s)) // 256) * 256 for s in SHAPES)
        assert out["wire"]["fp32"] == 4 * n
        assert out["wire"]["int8"] == padded + 4 * padded // 256
        assert out["wire"]["int8"] == pytest.approx(
            compression_ratio() * 4 * padded)


def test_ef_int8_error_feedback_converges(ef_world):
    """The reference's property (``tests/test_substrate.py``): the mean of
    what crossed over 200 steps is the gradient, the residual bounded."""
    ranks, _, g = ef_world
    for out in ranks:
        mean, res = out["converge"]
        np.testing.assert_allclose(mean.numpy(), g, rtol=0, atol=1e-2)
        assert float(res.abs().max()) < 0.1


def test_process_mesh_refuses_and_orders(ef_world):
    ranks, _, _ = ef_world
    for rank, out in enumerate(ranks):
        assert "needs 4 ranks, the world has 2" in out["refused"]["size"]
        assert "runs gloo, not nccl" in out["refused"]["backend"]
        assert out["groups"] == {"model_index": 0, "pod_index": rank,
                                 "pod_size": 2}


# ---------------------------------------------------------------------------
# Reduce-scatter onto blocks: one world of 4
# ---------------------------------------------------------------------------

RS_CASES = [(m, axes, dim)
            for m, axes in (("pod2_data2", ("data",)),
                            ("pod2_data2", ("pod", "data")),
                            ("pod2_model2", ("pod", "data")),
                            ("data2_model2", ("data",)),
                            ("ef", ("data",)))
            for dim in range(3)]


@pytest.fixture(scope="module")
def rs_world(tmp_path_factory):
    return _world(tmp_path_factory.mktemp("rs"), "world",
                  "reduce_scatter_blocks", 4, shape=(4, 8, 12))


@pytest.mark.parametrize("mesh,axes,dim", RS_CASES)
def test_reduce_scatter_equals_all_reduce_then_take_block(rs_world, mesh,
                                                          axes, dim):
    """``shardlib.reduce_scatter`` over ``data`` and over ``("pod",
    "data")`` with the FSDP dim on 0, 1 and 2: bit-equal to the all-reduce
    cut to the rank's block (``take_block``'s order) at two ranks along
    the axes, and with integer values at four; ``ef``: the sharded step's
    ``_onto_block`` in the EF-int8 layout (each pod's share kept, over
    ``data`` on pod 2 x data 2) against the all-reduce cut the same way."""
    blocks = set()
    for rank, out in enumerate(rs_world):
        got, want = out[(mesh, axes, dim)]
        assert got.shape == want.shape, (rank, got.shape, want.shape)
        assert torch.equal(got, want), rank
        blocks.add(got.numpy().tobytes())
    # Each block differs from the others: no rank got another's.
    assert len(blocks) > 1


# ---------------------------------------------------------------------------
# Expert-parallel MoE
# ---------------------------------------------------------------------------

def _moe_weights(cfg, seed=0):
    p = jinit_moe(jax.random.PRNGKey(seed), cfg)
    return {k: np.asarray(v) for k, v in p.items()}


def test_ep_moe_on_2x2_matches_reference(tmp_path):
    jc = jget_config("dbrx-132b", reduced=True)
    import dataclasses
    jc = dataclasses.replace(jc, compute_dtype="float32",
                             moe=dataclasses.replace(jc.moe,
                                                     capacity_factor=8.0))
    params = _moe_weights(jc)
    x = (np.random.default_rng(2).standard_normal((4, 16, jc.d_model))
         * 0.5).astype(np.float32)
    y_ref, _, _ = jmoe_ffn({k: jax.numpy.asarray(v)
                            for k, v in params.items()}, jax.numpy.asarray(x),
                           jc)
    ranks = _world(tmp_path, "ep22", "moe_ep", 4, arch="dbrx-132b",
                   capacity_factor=8.0, data=2, model=2, params=params, x=x,
                   want_grads=False)
    y_ref = np.asarray(y_ref)
    for out in ranks:
        d = out["coords"]["data"]
        np.testing.assert_allclose(out["ep"]["y"].numpy(),
                                   y_ref[2 * d:2 * d + 2], rtol=2e-4,
                                   atol=2e-4)
        assert float(out["ep"]["dropped"]) == 0.0


def test_ep_moe_on_1x2_equals_one_process_with_gradients(tmp_path):
    from torch_dist_workers import config
    cfg = config("dbrx-132b", capacity_factor=1.0)
    jc = jget_config("dbrx-132b", reduced=True)
    params = _moe_weights(jc, seed=3)
    x = (np.random.default_rng(4).standard_normal((2, 32, cfg.d_model))
         * 0.5).astype(np.float32)
    ranks = _world(tmp_path, "ep12", "moe_ep", 2, arch="dbrx-132b",
                   capacity_factor=1.0, data=1, model=2, params=params, x=x,
                   want_grads=True)
    e_loc = cfg.moe.num_experts // 2
    for out in ranks:
        ep, one = out["ep"], out["one"]
        # One data rank: the EP plan is the one-process plan, drops too.
        assert float(one["dropped"]) > 0
        assert torch.equal(ep["dropped"], one["dropped"])
        assert torch.equal(ep["aux"], one["aux"])
        tol = 1e-5 * float(one["y"].abs().max())
        assert float((ep["y"] - one["y"]).abs().max()) <= tol
        lo = out["coords"]["model"] * e_loc
        for k, g in ep["grads"].items():
            want = one["grads"][k]
            if k in ("w_gate", "w_up", "w_down"):
                # The rank's experts only; the others' gradients are 0.
                others = torch.cat([g[:lo], g[lo + e_loc:]])
                assert not others.any()
                g, want = g[lo:lo + e_loc], want[lo:lo + e_loc]
            err = float((g - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (k, err)
        # Remat's recompute off the forward's thread or mesh context
        # rebuilds the same expert-parallel plans: the gradients equal.
        remat = out["remat"]
        for where in ("after", "thread"):
            for k, g in remat["inside"].items():
                assert torch.equal(remat[where][k], g), (where, k)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_multi_host_flags_on_gloo(tmp_path):
    """``--distributed-init --mesh-data 1 --mesh-model 1 --multi-pod
    --compress-pods`` under ``torch.distributed.run``: a world of 2 on the
    pod axis trains with the EF-int8 all-reduce, both ranks log the same
    global losses, rank 0 writes the checkpoint."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    ckpt = tmp_path / "ckpt"
    logs = tmp_path / "logs"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "--log-dir", str(logs),
           "--redirects", "3", "-m", "repro_torch.launch.train",
           "--arch", "qwen2.5-3b", "--reduced", "--layers", "1",
           "--device", "cpu",
           "--steps", "10", "--global-batch", "4", "--seq-len", "32",
           "--ckpt-dir", str(ckpt), "--ckpt-every", "5",
           "--distributed-init", "--mesh-data", "1", "--mesh-model", "1",
           "--multi-pod", "--compress-pods"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=WORLD_TIMEOUT, cwd=tmp_path)
    outs = sorted(logs.rglob("stdout.log"))
    text = [p.read_text() for p in outs]
    assert proc.returncode == 0, (proc.stderr[-3000:], text)
    assert len(text) == 2
    for t in text:
        assert "finished at step 10" in t
    # The step-9 log line: the loss is the pods' mean, the same on both.
    losses = [[w for ln in t.splitlines() if ln.startswith("step 9:")
               for w in ln.split() if w.startswith("loss=")] for t in text]
    assert losses[0] == losses[1] and len(losses[0]) == 1
    assert np.isfinite(float(losses[0][0].split("=")[1]))
    steps = sorted(os.listdir(ckpt))
    assert steps == ["step_000000005", "step_000000010"]
    manifest = json.loads((ckpt / steps[-1] / "manifest.json").read_text())
    names = {a["name"] for a in manifest["arrays"]}
    # Each pod's residual: pod 0's under its own name, pod 1's beside it.
    res = sorted(n for n in names if n.startswith(".residuals/"))
    assert res and any(n.endswith("@pod1") for n in res)
    assert sorted(os.listdir(ckpt / steps[-1])) == [
        "COMMIT", "manifest.json", "shard_0.npz"]
