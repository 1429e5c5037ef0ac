"""Port parity: AdamW, its schedules and the global norm, against the
reference's ``repro.optim`` on the CPU.

The reference's three optimizer tests (``tests/test_substrate.py``) run
again on the port. Then ``apply`` runs several steps beside the
reference's on the same seeded parameters and gradients, for each
schedule, with clipping and weight decay on: parameters, both moments, the
step and the metrics within 1e-6 relative of the largest entry (the same
fp32 operations in the same order; ``cos`` and ``pow`` may differ by an
ulp between the frameworks). The update is in place: the parameters and
moments returned are the tensors passed in.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import optim  # noqa: E402


def test_adamw_matches_reference_math():
    cfg = optim.AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8,
                            weight_decay=0.0, grad_clip=0.0,
                            schedule="constant", warmup_steps=0)
    params = {"w": torch.tensor([1.0, 2.0])}
    grads = {"w": torch.tensor([0.5, -0.5])}
    state = optim.init(params)
    new_p, state, _ = optim.apply(cfg, params, grads, state)
    m = 0.1 * 0.5
    v = 0.01 * 0.25
    mhat, vhat = m / 0.1, v / 0.01
    want = 1.0 - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    assert float(new_p["w"][0]) == pytest.approx(want, rel=1e-5)
    assert new_p["w"] is params["w"]                 # updated in place
    assert int(state.step) == 1 and state.step.dtype == torch.int32


def test_grad_clip_limits_update():
    cfg = optim.AdamWConfig(lr=1.0, grad_clip=1e-6, weight_decay=0.0,
                            schedule="constant", warmup_steps=0)
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 1e6)}
    state = optim.init(params)
    _, _, metrics = optim.apply(cfg, params, grads, state)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


def test_schedule_warmup_and_decay():
    cfg = optim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                            schedule="cosine", min_lr_ratio=0.1)
    assert float(optim.learning_rate(cfg, torch.tensor(5))) == \
        pytest.approx(0.5)
    assert float(optim.learning_rate(cfg, torch.tensor(10))) == \
        pytest.approx(1.0)
    assert float(optim.learning_rate(cfg, torch.tensor(110))) == \
        pytest.approx(0.1)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_learning_rate_matches_reference(schedule):
    for warmup in (0, 1, 7):
        cfg = dict(lr=3e-4, warmup_steps=warmup, total_steps=40,
                   schedule=schedule, min_lr_ratio=0.1)
        for step in (0, 1, 3, 7, 8, 20, 39, 40, 41, 100):
            want = float(joptim.learning_rate(joptim.AdamWConfig(**cfg),
                                              jnp.asarray(step, jnp.int32)))
            got = optim.learning_rate(optim.AdamWConfig(**cfg),
                                      torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


def _tree(rng, scale=1.0):
    """A nested tree like a model's: dicts, a list, 1-D and 2-D leaves."""
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": {"embedding": a(16, 8)},
            "stack": {"prefix": [{"w": a(8, 8), "b": a(8)}],
                      "slots": ({"norm": {"scale": a(8)}, "w": a(8, 4)},)},
            "final": a(8)}


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_apply_matches_reference_over_steps(schedule, clip):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=8, schedule=schedule,
               weight_decay=0.1, grad_clip=clip)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = jax.tree.map(lambda x: torch.from_numpy(x.copy()), p0)
    js, ts = joptim.init(jp), optim.init(tp)
    jcfg, tcfg = joptim.AdamWConfig(**cfg), optim.AdamWConfig(**cfg)
    for step in range(6):
        g = _tree(rng, scale=10.0 ** (step % 3 - 1))   # clip on and off
        jp, js, jm = joptim.apply(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = optim.apply(
            tcfg, tp, jax.tree.map(lambda x: torch.from_numpy(x), g), ts)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    assert int(ts.step) == int(js.step) == 6
    for mine, ref in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-6 * np.abs(b).max())


def test_weight_decay_reaches_every_leaf():
    """Norm scales and biases decay too, as in the reference (ROADMAP
    Queue C): with zero gradients each leaf shrinks by lr * wd * p."""
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=0.0,
                            schedule="constant", warmup_steps=0)
    params = {"norm": {"scale": torch.ones(3)}, "bias": torch.full((2,), 2.0)}
    grads = {"norm": {"scale": torch.zeros(3)}, "bias": torch.zeros(2)}
    optim.apply(cfg, params, grads, optim.init(params))
    assert torch.allclose(params["norm"]["scale"], torch.full((3,), 0.95))
    assert torch.allclose(params["bias"], torch.full((2,), 1.9))


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    t = _tree(rng, 3.0)
    want = float(joptim.global_norm(jax.tree.map(jnp.asarray, t)))
    got = optim.global_norm(jax.tree.map(torch.from_numpy, t))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == pytest.approx(want, rel=1e-6)
