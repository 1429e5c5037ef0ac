"""Port parity: the training path (loss, gradients, remat, the train step,
the trainer and its launcher) against the reference, on the CPU.

The loss and every leaf's gradient come from the port's
``grads_and_metrics`` and from ``jax.value_and_grad(repro.models.loss_fn)``
on the reference's own weights (through ``params_from_jax``) and the same
seeded batch, for the reduced qwen2.5-3b, qwen3-14b (q/k norm), gemma3-12b
(sliding windows) and starcoder2-15b. In fp32 compute the two agree to a
few ulps of fp32 arithmetic: the loss within 1e-5 relative, each leaf
within 1e-4 of its largest reference entry. In bf16 (the configs' default)
the frameworks round at other places: the loss within 1e-3 relative and
every leaf's gradient at cosine >= 0.999 to the reference's. Every
other family's reduced config trains too (finite gradients under remat);
``test_torch_train_families.py`` and ``test_torch_train_family_steps.py``
hold those six against the reference as well.

Three ``train_step``s from one state (``train_state_from_jax``) hold every
metric within 1e-5 relative, both moments within 1e-4 of their largest
entry and the parameters within that plus 5 % of one step (lr): AdamW
divides by sqrt(v), so a gradient that is pure rounding noise (the key
bias's) moves its parameter by up to lr in either package (fp32 compute).
The trainer's resume must give exactly the losses of an uninterrupted run.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import grads_and_metrics as jgrads_and_metrics  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import train_step as jtrain_step  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import (  # noqa: E402
    init_params,
    loss_fn,
    params_from_jax,
    train_state_from_jax,
)
from repro_torch.models.layers import softmax_cross_entropy  # noqa: E402
from repro_torch.train import (  # noqa: E402
    StragglerMonitor,
    Trainer,
    TrainConfig,
    TrainerConfig,
    grads_and_metrics,
    init_state,
    make_train_step,
)
from repro_torch.tree import flatten  # noqa: E402

ARCHS = ["qwen2.5-3b", "qwen3-14b", "gemma3-12b", "starcoder2-15b"]


def _configs(arch, compute="bfloat16", **kw):
    jc = dataclasses.replace(jget_config(arch, reduced=True),
                             compute_dtype=compute, **kw)
    tc = dataclasses.replace(get_config(arch, reduced=True),
                             compute_dtype=compute, **kw)
    return jc, tc


def _batch(vocab, seed, b=2, s=32):
    """A packed batch from the port's data pipeline, as numpy."""
    out = make_batch(DataConfig(vocab_size=vocab, seq_len=s, global_batch=b,
                                seed=seed, mean_doc_len=16), 0)
    return {k: out[k] for k in ("tokens", "labels", "loss_mask")}


def _both(jc, tc, seed=0):
    jp = jinit(jax.random.PRNGKey(seed), jc)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")


def _torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def _jax_batch(nb):
    return {k: jnp.asarray(v) for k, v in nb.items()}


def _port_tree(tree, tc):
    """A reference tree of the parameters' structure as the port's."""
    return flatten(params_from_jax(jax.tree.map(np.asarray, tree), tc,
                                   "cpu"))


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------

def test_softmax_cross_entropy_matches_reference():
    from repro.models.layers import softmax_cross_entropy as jce
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    for m in (mask, None, np.zeros_like(mask)):
        jl, jm = jce(jnp.asarray(logits).astype(jnp.bfloat16),
                     jnp.asarray(labels),
                     None if m is None else jnp.asarray(m))
        tl, tm = softmax_cross_entropy(
            torch.from_numpy(logits).to(torch.bfloat16),
            torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        for k in ("ce", "z_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, compute):
    jc, tc = _configs(arch, compute)
    jp, tp = _both(jc, tc)
    nb = _batch(jc.vocab_size, 1)
    (jl, jm), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        jp, _jax_batch(nb), jc)
    grads, metrics = grads_and_metrics(tp, _torch_batch(nb), tc, 1)
    assert set(metrics) == {"ce", "z_loss", "aux", "loss"}
    want, got = _port_tree(jg, tc), flatten(grads)
    assert set(got) == set(want)
    if compute == "float32":
        np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                                   rtol=1e-5)
        for k in ("ce", "z_loss"):
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                       rtol=1e-5)
        for k, w in want.items():
            err = float((got[k] - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()) + 1e-12, (k, err)
    else:
        np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                                   rtol=1e-3)
        for k, w in want.items():
            if float(w.abs().max()) == 0:
                assert float(got[k].abs().max()) == 0, k
                continue
            assert _cos(got[k], w) >= 0.999, (k, _cos(got[k], w))


def test_loss_fn_value_is_the_reference_formula():
    """``loss_fn`` = cross entropy + 1e-4 * z-loss + aux, in fp32."""
    _, tc = _configs("qwen2.5-3b", "float32")
    params = init_params(0, tc, "cpu")
    nb = _torch_batch(_batch(tc.vocab_size, 2))
    with torch.no_grad():
        total, m = loss_fn(params, nb, tc)
    assert total.dtype == torch.float32
    assert float(total) == float(m["loss"])
    np.testing.assert_allclose(
        float(total), float(m["ce"] + 1e-4 * m["z_loss"] + m["aux"]),
        rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma3-12b"])
def test_remat_policies_agree(arch):
    """"none", "minimal" and "full" give the same loss and gradients (the
    recomputed forward is the same arithmetic)."""
    out = {}
    for policy in ("none", "minimal", "full"):
        _, tc = _configs(arch, "float32", remat_policy=policy)
        params = init_params(0, tc, "cpu")
        grads, m = grads_and_metrics(
            params, _torch_batch(_batch(tc.vocab_size, 3)), tc, 1)
        out[policy] = (float(m["loss"]), flatten(grads))
    loss0, g0 = out["none"]
    for policy in ("minimal", "full"):
        loss, g = out[policy]
        assert loss == loss0
        for k in g0:
            torch.testing.assert_close(g[k], g0[k], rtol=1e-6, atol=1e-7)


def test_remat_minimal_recomputes_all_but_projections():
    """Ops the backward runs: "full" recomputes the periods' matmuls,
    "minimal" takes them from what it saved but recomputes the rest
    (norms, RoPE, activations), "none" recomputes nothing."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] += 1
            return func(*args, **(kwargs or {}))

    mm = torch.ops.aten.mm.default
    ops = {}
    for policy in ("none", "minimal", "full"):
        _, tc = _configs("qwen2.5-3b", "float32", remat_policy=policy)
        params = init_params(0, tc, "cpu")
        for p in flatten(params).values():
            p.requires_grad_()
        loss, _ = loss_fn(params, _torch_batch(_batch(tc.vocab_size, 4)), tc)
        with Count() as count:
            loss.backward()
        ops[policy] = count.ops
    assert ops["none"][mm] == ops["minimal"][mm] < ops["full"][mm]
    assert sum(ops["none"].values()) < sum(ops["minimal"].values()) \
        < sum(ops["full"].values())


def test_grads_under_no_grad_cover_every_leaf():
    """``grads_and_metrics`` works under ``torch.no_grad()`` (it enables
    grad itself), returns a gradient for every leaf, and leaves the
    parameters without ``requires_grad``."""
    _, tc = _configs("starcoder2-15b", "float32")
    params = init_params(0, tc, "cpu")
    with torch.no_grad():
        grads, _ = grads_and_metrics(
            params, _torch_batch(_batch(tc.vocab_size, 5)), tc, 1)
    assert flatten(grads).keys() == flatten(params).keys()
    assert not any(p.requires_grad for p in flatten(params).values())
    assert all(torch.isfinite(g).all() for g in flatten(grads).values())


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_has_gradients_under_remat(arch):
    """Every family (MoE, MLA, the SSD, the hybrid, the encoder-decoder
    with stub frames, the VLM with stub patches) under its config's remat
    policy: a finite loss and a finite gradient for every leaf that the
    loss reaches, and at least one nonzero gradient in every block."""
    _, tc = _configs(arch)
    params = init_params(0, tc, "cpu")
    batch = _torch_batch(_batch(tc.vocab_size, 8))
    rng = np.random.default_rng(8)
    if tc.prefix_len:
        batch["prefix_embeds"] = torch.from_numpy(
            rng.standard_normal((2, tc.prefix_len, tc.d_model), np.float32)
            * 0.02)
    if tc.is_encdec:
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, 16, tc.d_model), np.float32) * 0.02)
    grads, m = grads_and_metrics(params, batch, tc, 1)
    assert np.isfinite(float(m["loss"]))
    flat = flatten(grads)
    assert flat.keys() == flatten(params).keys()
    assert all(bool(torch.isfinite(g).all()) for g in flat.values())
    blocks = {k.rsplit("/", 2)[0] for k in flat if "/mixer/" in k}
    for blk in blocks:
        assert any(float(g.abs().max()) > 0 for k, g in flat.items()
                   if k.startswith(blk + "/")), blk


# ---------------------------------------------------------------------------
# Microbatches and the train step
# ---------------------------------------------------------------------------

def test_microbatches_match_one_batch_and_the_reference():
    jc, tc = _configs("qwen2.5-3b", "float32")
    jp, tp = _both(jc, tc)
    nb = _batch(jc.vocab_size, 6, b=4)
    g1, m1 = grads_and_metrics(tp, _torch_batch(nb), tc, 1)
    g2, m2 = grads_and_metrics(tp, _torch_batch(nb), tc, 2)
    assert set(m2) == {"loss"}
    jg2, jm2 = jgrads_and_metrics(jp, _jax_batch(nb), jc, 2)
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                               rtol=1e-5)
    want = _port_tree(jg2, tc)
    a, b = flatten(g2), flatten(g1)
    for k, w in want.items():
        scale = float(w.abs().max()) + 1e-12
        assert float((a[k] - w).abs().max()) <= 1e-4 * scale, k
        # Two halves of the batch, each a mean over its own mask: close to
        # the one-batch gradient, not equal.
        assert _cos(a[k], b[k]) >= 0.99, k


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_three_train_steps_match_reference(schedule):
    jc, tc = _configs("qwen2.5-3b", "float32")
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=6, schedule=schedule,
                weight_decay=0.1, grad_clip=1.0)
    jt = JTrainConfig(optimizer=joptim.AdamWConfig(**ocfg))
    tt = TrainConfig(optimizer=optim.AdamWConfig(**ocfg))
    jp = jinit(jax.random.PRNGKey(0), jc)
    jstate = jinit_state(jp, jt)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), tc, "cpu")
    step = make_train_step(tc, tt)
    for i in range(3):
        nb = _batch(jc.vocab_size, 10 + i)
        jstate, jm = jtrain_step(jstate, _jax_batch(nb), jc, jt)
        state, m = step(state, _torch_batch(nb))
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    for name, mine, ref in (("params", state.params, jstate.params),
                            ("m", state.opt.m, jstate.opt.m),
                            ("v", state.opt.v, jstate.opt.v)):
        want, got = _port_tree(ref, tc), flatten(mine)
        # The key bias's true gradient is 0 (a softmax does not see a shift
        # of all its scores), so both packages feed AdamW rounding noise,
        # which it turns into steps of up to lr: parameters are held
        # within 5 % of one step beside the 1e-4 relative.
        slack = 0.05 * ocfg["lr"] if name == "params" else 1e-12
        for k, w in want.items():
            err = float((got[k] - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()) + slack, (name, k, err)


def test_loss_falls_over_eight_steps():
    _, tc = _configs("qwen2.5-3b")
    tt = TrainConfig(optimizer=optim.AdamWConfig(lr=3e-3, warmup_steps=1,
                                                 total_steps=8))
    state = init_state(init_params(0, tc, "cpu"), tt)
    step = make_train_step(tc, tt)
    nb = _torch_batch(_batch(tc.vocab_size, 7, b=4))
    losses = []
    for _ in range(8):
        state, m = step(state, nb)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5


# ---------------------------------------------------------------------------
# The trainer and its launcher
# ---------------------------------------------------------------------------

def _trainer(tc, tmp_path, total, every, name):
    tt = TrainConfig(optimizer=optim.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                 total_steps=6))
    run = TrainerConfig(total_steps=total, checkpoint_every=every,
                        checkpoint_dir=str(tmp_path / name),
                        keep_checkpoints=2, log_every=1)
    dcfg = DataConfig(vocab_size=tc.vocab_size, seq_len=32, global_batch=2,
                      mean_doc_len=16)
    return Trainer(tc, tt, run, dcfg, device="cpu")


def test_trainer_resume_equals_an_uninterrupted_run(tmp_path):
    _, tc = _configs("qwen2.5-3b")
    whole = _trainer(tc, tmp_path, 6, 100, "whole").train()
    first = _trainer(tc, tmp_path, 4, 2, "split").train()
    second = _trainer(tc, tmp_path, 6, 2, "split").train()
    assert first["final_step"] == 4 and second["final_step"] == 6
    assert first["losses"] + second["losses"] == whole["losses"]
    assert _trainer(tc, tmp_path, 6, 2, "split").ckpt.committed_steps() \
        == [4, 6]


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, tc = _configs("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Trainer(tc, TrainConfig(), TrainerConfig(),
                DataConfig(vocab_size=tc.vocab_size, seq_len=8,
                           global_batch=1))


def test_straggler_monitor_matches_reference():
    from repro.train import StragglerMonitor as JStragglerMonitor
    times = [1.0, 1.1, 0.9, 5.0, 1.0, 1.2, 4.0, 0.1, 9.0]
    mine, ref = StragglerMonitor(3.0), JStragglerMonitor(3.0)
    flags = [mine.observe(i, t) for i, t in enumerate(times)]
    assert flags == [ref.observe(i, t) for i, t in enumerate(times)]
    assert mine.flagged == ref.flagged == [3, 8]
    assert mine.ewma == pytest.approx(ref.ewma)


def test_launch_train_reduced_on_cpu(tmp_path, capsys):
    result = launch_train.main(["--arch", "qwen2.5-3b", "--reduced",
                                "--device", "cpu", "--steps", "3",
                                "--global-batch", "2", "--seq-len", "32",
                                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert result["final_step"] == 3 and len(result["losses"]) == 3
    assert all(np.isfinite(result["losses"]))
    assert "finished at step 3" in out
    assert (tmp_path / "step_000000003" / "COMMIT").exists()
