"""Port parity: training every family that ``test_torch_train.py`` does not
hold, against the reference, on the CPU.

The MoE archs (dbrx-132b, deepseek-v2-236b with MLA, the hybrid
jamba-v0.1-52b), the SSD (mamba2-780m), the encoder-decoder
(seamless-m4t-medium, stub ``frames``) and the VLM (phi-3-vision-4.2b,
stub ``prefix_embeds``), reduced. Their gradients go through the MoE ops'
autograd Functions (the plain backwards here; the kernels on the card).
The loss and every leaf's gradient from the port's ``grads_and_metrics``
are held against ``jax.value_and_grad(repro.models.loss_fn)`` on the
reference's own weights and the same seeded batch with
``test_torch_train.py``'s bounds: in fp32 compute the loss within 1e-5
relative and each leaf within 1e-4 of its largest reference entry; in
bf16 (the three archs without experts: a bf16 near-tie may route a copy
to another expert in one framework only) the loss within 1e-3 relative
and every leaf at cosine >= 0.999. Three ``train_step``s from one
``train_state_from_jax`` state hold the metrics, moments and parameters
with the step test's bounds (``test_torch_train_family_steps.py``, a
file of its own so that the two halves run on two workers). Under remat
the recompute rebuilds the forward's dispatch plans exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.train import grads_and_metrics  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from test_torch_train import (  # noqa: E402
    _batch,
    _both,
    _configs,
    _cos,
    _jax_batch,
    _port_tree,
    _torch_batch,
)

MOE_ARCHS = ["dbrx-132b", "deepseek-v2-236b", "jamba-v0.1-52b"]
DENSE_ARCHS = ["mamba2-780m", "seamless-m4t-medium", "phi-3-vision-4.2b"]
ARCHS = MOE_ARCHS + DENSE_ARCHS
ENC_FRAMES = 12


def _family_batch(cfg, seed, b=2):
    """The data pipeline's batch plus the arch's stub frontend inputs."""
    nb = _batch(cfg.vocab_size, seed, b=b)
    rng = np.random.default_rng(seed + 100)
    if cfg.is_encdec:
        nb["frames"] = (rng.standard_normal((b, ENC_FRAMES, cfg.d_model))
                        * 0.02).astype(np.float32)
    if cfg.prefix_len:
        nb["prefix_embeds"] = (rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model)) * 0.02).astype(np.float32)
    return nb


@pytest.mark.parametrize("arch,compute",
                         [(a, "float32") for a in ARCHS]
                         + [(a, "bfloat16") for a in DENSE_ARCHS])
def test_family_loss_and_grads_match_reference(arch, compute):
    jc, tc = _configs(arch, compute)
    jp, tp = _both(jc, tc)
    nb = _family_batch(tc, 1)
    (jl, jm), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        jp, _jax_batch(nb), jc)
    grads, metrics = grads_and_metrics(tp, _torch_batch(nb), tc, 1)
    want, got = _port_tree(jg, tc), flatten(grads)
    assert set(got) == set(want)
    if compute == "float32":
        np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                                   rtol=1e-5)
        for k in ("ce", "z_loss", "aux"):
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7)
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


@pytest.mark.parametrize("policy", ["minimal", "full"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-v0.1-52b"])
def test_remat_recompute_rebuilds_the_dispatch_plans(arch, policy):
    """Under remat every MoE layer's plan is computed twice, in the forward
    and in the backward's recompute (periods in reverse order, layers of a
    period in order): each recomputed plan must be its forward plan, or the
    backward would differentiate another routing."""
    from unittest import mock
    jc, tc = _configs(arch, "float32", remat_policy=policy)
    _, params = _both(jc, tc)
    plans, real = [], moe.moe_dispatch_plan

    def recording(*args):
        plans.append(real(*args))
        return plans[-1]

    with mock.patch.object(moe, "moe_dispatch_plan", recording):
        grads_and_metrics(params, _torch_batch(_family_batch(tc, 3)), tc, 1)
    n_moe = len(plans) // 2
    assert n_moe >= 2 and len(plans) == 2 * n_moe
    per_period = sum(f == "moe" for _, f in tc.block_pattern)
    forward = [plans[i:i + per_period] for i in range(0, n_moe, per_period)]
    again = [plans[n_moe + i:n_moe + i + per_period]
             for i in range(0, n_moe, per_period)]
    for first, second in zip(forward, reversed(again)):
        for a, b in zip(first, second):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
