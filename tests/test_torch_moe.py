"""Port parity: the MoE dispatch plan, the gather and combine kernels' plain
versions, and the MoE layer.

The plan must match the reference exactly for the same router
probabilities (slots, inverse slots, the drop count; the weights within
1e-6), ties included: the reference's top-k puts the lower expert index
first, and the port takes its top-k through a stable sort. The Pallas
kernels run in interpret mode, as ``tests/test_kernels.py`` runs them; the
gather is held bit for bit, the combine within 1e-5 (the einsum and the
kernel sum in another order). ``moe_ffn`` is held within rtol = 1e-5 in
fp32 and 3e-2 in bf16 (the two frameworks round the bf16 products at other
places: a few bf16 ulps, 2**-8 relative each), with atol the same
fraction of the largest output (the outputs reach tens, and an element
near 0 is a difference of such terms);
every case asserts that its router's top-k margin exceeds 1e-4, so that a
flipped expert choice would show as such. ``tests/test_torch_cuda.py``
holds the CUDA kernels against these plain versions on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_dispatch import (  # noqa: E402
    moe_combine as jcombine,
    moe_gather as jgather,
)
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.moe_dispatch import (  # noqa: E402
    moe_combine,
    moe_combine_plain,
    moe_gather,
    moe_gather_plain,
)
from repro_torch.models import moe  # noqa: E402

I = dict(interpret=True)

MOE_CFGS = {
    "dbrx-reduced": dict(num_experts=4, experts_per_token=2, expert_d_ff=64,
                         capacity_factor=1.5),
    "dbrx": dict(num_experts=16, experts_per_token=4, expert_d_ff=10752,
                 capacity_factor=1.25),
    "deepseek-reduced": dict(num_experts=8, experts_per_token=2,
                             expert_d_ff=32, num_shared_experts=1,
                             shared_d_ff=64, capacity_factor=1.5),
    "deepseek": dict(num_experts=160, experts_per_token=6, expert_d_ff=1536,
                     num_shared_experts=2, shared_d_ff=3072,
                     capacity_factor=1.25),
    "no-renorm": dict(num_experts=8, experts_per_token=3, expert_d_ff=16,
                      capacity_factor=1.0, router_norm_topk=False),
}


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _plans(probs, kw, cap):
    jp = jmoe.moe_dispatch_plan(jnp.asarray(probs), JMoEConfig(**kw), cap)
    tp = moe.moe_dispatch_plan(torch.from_numpy(probs), MoEConfig(**kw), cap)
    return jp, tp


def _assert_plans_equal(jp, tp):
    np.testing.assert_array_equal(tp.token_idx.numpy(),
                                  np.asarray(jp.token_idx))
    np.testing.assert_array_equal(tp.inv_slot.numpy(),
                                  np.asarray(jp.inv_slot))
    assert int(tp.num_dropped) == int(jp.num_dropped)
    np.testing.assert_allclose(tp.weight.numpy(), np.asarray(jp.weight),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.inv_weight.numpy(),
                               np.asarray(jp.inv_weight), rtol=1e-6,
                               atol=1e-6)
    assert tp.token_idx.dtype == torch.int32
    assert tp.inv_slot.dtype == torch.int32


@pytest.mark.parametrize("t", [1, 8, 37, 300])
@pytest.mark.parametrize("name", sorted(MOE_CFGS))
def test_capacity_matches(t, name):
    kw = MOE_CFGS[name]
    assert moe.capacity(t, MoEConfig(**kw)) == \
        jmoe.capacity(t, JMoEConfig(**kw))


@pytest.mark.parametrize("name", sorted(MOE_CFGS))
@pytest.mark.parametrize("t", [16, 96])
def test_dispatch_plan_matches_jax(name, t):
    kw = MOE_CFGS[name]
    rng = np.random.default_rng(t)
    probs = _softmax(rng.standard_normal((t, kw["num_experts"])) * 2)
    cap = jmoe.capacity(t, JMoEConfig(**kw))
    jp, tp = _plans(probs, kw, cap)
    _assert_plans_equal(jp, tp)


def test_dispatch_plan_drops_and_empty_slots():
    """A skewed router overflows one expert and starves another: both -1
    rules of the plan are exercised, and still match."""
    kw = MOE_CFGS["dbrx-reduced"]
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((64, 4))
    logits[:, 0] += 3.0                           # expert 0 is everyone's
    logits[:, 3] -= 3.0                           # expert 3 is no one's
    probs = _softmax(logits)
    cap = jmoe.capacity(64, JMoEConfig(**kw))
    jp, tp = _plans(probs, kw, cap)
    _assert_plans_equal(jp, tp)
    assert int(tp.num_dropped) > 0
    assert int((tp.token_idx < 0).sum()) > 0


@pytest.mark.parametrize("name", ["dbrx-reduced", "dbrx", "no-renorm"])
def test_dispatch_plan_exact_ties(name):
    """Equal probabilities: the lower expert index wins, as in the
    reference; torch.topk alone promises no order among ties."""
    kw = MOE_CFGS[name]
    e = kw["num_experts"]
    rng = np.random.default_rng(11)
    levels = np.array([0.5, 1.0, 1.0, 2.0], np.float32)
    probs = levels[rng.integers(0, 4, (40, e))]
    probs[0] = 1.0                                 # one row all equal
    probs[1, ::2] = 3.0                            # ties at the top
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    cap = jmoe.capacity(40, JMoEConfig(**kw))
    jp, tp = _plans(probs, kw, cap)
    _assert_plans_equal(jp, tp)
    topv, topi = moe.top_k(torch.from_numpy(probs), kw["experts_per_token"])
    jv, ji = jax.lax.top_k(jnp.asarray(probs), kw["experts_per_token"])
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(topv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# The kernels' plain versions (shapes of tests/test_kernels.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gather_plain_matches_pallas(dtype):
    rng = np.random.default_rng(0)
    t, d, slots = 32, 128, 48
    tokens = rng.standard_normal((t, d)).astype(np.float32)
    idx = rng.integers(-1, t, slots).astype(np.int32)
    jt = jnp.asarray(tokens).astype(dtype)
    want = np.asarray(jgather(jnp.asarray(idx), jt, **I).astype(jnp.float32))
    tt = torch.from_numpy(tokens).to(getattr(torch, dtype))
    got = moe_gather(torch.from_numpy(idx), tt)
    assert got.dtype == tt.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        tref.moe_gather_ref(torch.from_numpy(idx), tt).float().numpy(),
        np.asarray(jref.moe_gather_ref(jnp.asarray(idx), jt)
                   .astype(jnp.float32)))


@pytest.mark.parametrize("k", [2, 4])
def test_moe_combine_plain_matches_pallas(k):
    rng = np.random.default_rng(1)
    t, d, slots = 16, 128, 64
    eo = rng.standard_normal((slots, d)).astype(np.float32)
    inv_slot = rng.integers(-1, slots, (t, k)).astype(np.int32)
    inv_w = rng.random((t, k)).astype(np.float32)
    want = np.asarray(jcombine(jnp.asarray(inv_slot), jnp.asarray(inv_w),
                               jnp.asarray(eo), **I))
    args = (torch.from_numpy(inv_slot), torch.from_numpy(inv_w),
            torch.from_numpy(eo))
    got = moe_combine(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tref.moe_combine_ref(*args).numpy(),
        np.asarray(jref.moe_combine_ref(jnp.asarray(inv_slot),
                                        jnp.asarray(inv_w), jnp.asarray(eo))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, tref.moe_combine_ref(*args).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_moe_combine_bf16_matches_pallas():
    rng = np.random.default_rng(2)
    t, k, d, slots = 16, 3, 128, 40
    eo = rng.standard_normal((slots, d)).astype(np.float32)
    inv_slot = rng.integers(-1, slots, (t, k)).astype(np.int32)
    inv_w = rng.random((t, k)).astype(np.float32)
    want = np.asarray(jcombine(jnp.asarray(inv_slot), jnp.asarray(inv_w),
                               jnp.asarray(eo).astype(jnp.bfloat16), **I)
                      .astype(jnp.float32))
    got = moe_combine(torch.from_numpy(inv_slot), torch.from_numpy(inv_w),
                      torch.from_numpy(eo).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # fp32 sums that differ in the last bits may round to neighbouring bf16.
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3,
                               atol=8e-3)


def test_moe_combine_skips_dropped_rows_without_reading():
    """A -1 entry reads no row: a non-finite row 0 does not leak into the
    sum (the TPU kernel reads row max(-1, 0) and multiplies it by 0)."""
    eo = torch.ones((8, 16))
    eo[0] = float("nan")
    inv_slot = torch.tensor([[-1, 3], [-1, -1], [5, -1]], dtype=torch.int32)
    inv_w = torch.tensor([[0.7, 0.5], [0.2, 0.3], [0.25, 0.9]])
    out = moe_combine_plain(inv_slot, inv_w, eo)
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.full((16,), 0.5))
    assert torch.equal(out[1], torch.zeros(16))
    assert torch.equal(out[2], torch.full((16,), 0.25))
    g = moe_gather_plain(torch.tensor([-1, 1], dtype=torch.int32), eo)
    assert torch.equal(g[0], torch.zeros(16)) and torch.equal(g[1], eo[1])


def test_moe_combine_rounds_product_and_sum_separately():
    """acc + w * x with each step rounded to fp32: the rule the CUDA kernel
    keeps with __fmul_rn / __fadd_rn (a fused multiply-add differs)."""
    w = np.float32(1.0 + 2.0 ** -12)
    x = np.float32(1.0 + 2.0 ** -12)
    eo = torch.tensor([[x], [-1.0]], dtype=torch.float32)
    inv_slot = torch.tensor([[0, 1]], dtype=torch.int32)
    inv_w = torch.tensor([[w, 1.0]], dtype=torch.float32)
    got = float(moe_combine_plain(inv_slot, inv_w, eo)[0, 0])
    twice = np.float32(np.float32(w * x) + np.float32(-1.0))
    fused = np.float32(np.float64(w) * np.float64(x) - 1.0)
    assert got == float(twice) and twice != fused


def test_moe_ops_on_cpu_run_the_plain_versions():
    before = build.launch_counts()
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.standard_normal((10, 24)).astype(np.float32))
    idx = torch.tensor([3, -1, 9, 0], dtype=torch.int32)
    assert torch.equal(ops.moe_gather_op(idx, tokens),
                       moe_gather_plain(idx, tokens))
    inv_slot = torch.tensor([[0, -1], [2, 3]], dtype=torch.int32)
    inv_w = torch.tensor([[1.0, 0.0], [0.25, 0.75]])
    rows = ops.moe_gather_op(idx, tokens)
    assert torch.equal(ops.moe_combine_op(inv_slot, inv_w, rows),
                       moe_combine_plain(inv_slot, inv_w, rows))
    assert build.launch_counts() == before


def test_moe_wrappers_reject_bad_inputs():
    tokens = torch.zeros((4, 8))
    with pytest.raises(TypeError):
        moe_gather(torch.tensor([0, 1]), tokens)           # int64 indices
    with pytest.raises(TypeError):
        moe_combine(torch.zeros((2, 2), dtype=torch.int32),
                    torch.zeros((2, 3)), tokens)            # weight shape
    with pytest.raises(TypeError):
        moe_combine(torch.zeros((2, 2), dtype=torch.int32),
                    torch.zeros((2, 2)), tokens.to(torch.int32))


def test_moe_kernels_roundtrip_plan():
    """Gather then combine with identity experts gives back the tokens when
    nothing is dropped and the top-k weights are renormalised."""
    kw = dict(num_experts=4, experts_per_token=2, expert_d_ff=8,
              capacity_factor=2.0)
    rng = np.random.default_rng(4)
    t, d = 32, 128
    tokens = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    probs = torch.from_numpy(_softmax(rng.standard_normal((t, 4))))
    m = MoEConfig(**kw)
    plan = moe.moe_dispatch_plan(probs, m, moe.capacity(t, m))
    assert int(plan.num_dropped) == 0
    xe = moe_gather(plan.token_idx, tokens)
    y = moe_combine(plan.inv_slot, plan.inv_weight, xe)
    np.testing.assert_allclose(y.numpy(), tokens.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

def _tree(p):
    if isinstance(p, dict):
        return {k: _tree(v) for k, v in p.items()}
    return torch.from_numpy(np.array(p, copy=True))


def _margin(x, router, k):
    probs = _softmax(x.reshape(-1, x.shape[-1]).astype(np.float64)
                     @ router.astype(np.float64))
    top = -np.sort(-probs, axis=-1)
    return float((top[:, k - 1] - top[:, k]).min())


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_moe_ffn_matches_jax(arch, dtype, tol):
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype=dtype)
    params = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(3),
                                                    jcfg))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    x_used = np.asarray(jx.astype(jnp.float32))
    assert _margin(x_used, params["router"],
                   jcfg.moe.experts_per_token) > 1e-4
    jy, jaux, jmet = jmoe.moe_ffn(params, jx, jcfg)
    ty, taux, tmet = moe.moe_ffn(_tree(params),
                                 torch.from_numpy(x).to(getattr(torch, dtype)),
                                 tcfg)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == x.shape
    want = np.asarray(jy.astype(jnp.float32))
    # The outputs reach tens (expert weights are drawn with fan-in E), and
    # an element near 0 is a difference of such sums: atol scales with them.
    np.testing.assert_allclose(ty.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["moe_dropped"]),
                               float(jmet["moe_dropped"]), rtol=1e-6)
    for key in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5)
