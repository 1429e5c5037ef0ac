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

The backwards' plain versions are held against ``jax.vjp`` of the
reference's own gather and combine expressions (``d_tokens`` and
``d_expert_out`` within 1e-6 relative, fp32 summation order;
``d_inv_weight`` within 1e-5 of its largest entry); the plan's duality,
on which the backwards rest, is a property over T, E, k and capacity; and
``moe_ffn``'s gradients through the ops' autograd Functions are held
against the reference's layer within 1e-4 of each largest entry.
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
    moe_combine_backward_plain,
    moe_combine_plain,
    moe_gather,
    moe_gather_backward_plain,
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


# ---------------------------------------------------------------------------
# The backwards: the plain versions against jax.vjp of the reference's own
# gather and combine expressions, the plan's duality, moe_ffn's gradients
# ---------------------------------------------------------------------------

def _jax_gather(plan, e, cap, dt):
    """The reference's gather, ``src/repro/models/moe.py:233-235``."""
    def gather(xt):
        d = xt.shape[-1]
        safe = jnp.maximum(plan.token_idx, 0)
        xe = xt[safe].reshape(e, cap, d).astype(dt)
        return xe * (plan.token_idx >= 0).reshape(e, cap, 1).astype(dt)
    return gather


def _jax_combine(inv_slot, dt):
    """The reference's combine, ``src/repro/models/moe.py:249-252``, as a
    function of the flat expert outputs and the combine weights."""
    def combine(flat_y, inv_weight):
        rows = flat_y[jnp.maximum(inv_slot, 0)]          # (T, k, d)
        w = jnp.where(inv_slot >= 0, inv_weight, 0.0)
        return jnp.einsum("tk,tkd->td", w.astype(jnp.float32),
                          rows.astype(jnp.float32)).astype(dt)
    return combine


def _skewed_plans(name, t, seed):
    """Both packages' plans for one skewed router (drops and empty slots)."""
    kw = MOE_CFGS[name]
    e = kw["num_experts"]
    rng = np.random.default_rng(seed)
    probs = _softmax(rng.standard_normal((t, e)) * 2
                     + np.linspace(-2, 2, e))
    cap = jmoe.capacity(t, JMoEConfig(**kw))
    jp, tp = _plans(probs, kw, cap)
    _assert_plans_equal(jp, tp)
    return jp, tp, e, cap


@pytest.mark.parametrize("name", ["dbrx-reduced", "deepseek-reduced",
                                  "no-renorm"])
def test_moe_gather_backward_plain_matches_jax_vjp(name):
    """d_tokens = the scatter-add XLA differentiates the gather into,
    computed as a gather through inv_slot: exact up to fp32 summation
    order."""
    jp, tp, e, cap = _skewed_plans(name, 96, 21)
    assert int(tp.num_dropped) > 0 and int((tp.token_idx < 0).sum()) > 0
    rng = np.random.default_rng(22)
    d = 24
    xt = rng.standard_normal((96, d)).astype(np.float32)
    g = rng.standard_normal((e * cap, d)).astype(np.float32)
    _, vjp = jax.vjp(_jax_gather(jp, e, cap, jnp.float32), jnp.asarray(xt))
    want = np.asarray(vjp(jnp.asarray(g).reshape(e, cap, d))[0])
    got = moe_gather_backward_plain(tp.inv_slot, torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (96, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", ["dbrx-reduced", "deepseek-reduced",
                                  "no-renorm"])
def test_moe_combine_backward_plain_matches_jax_vjp(name):
    """d_expert_out = w * dy in each kept copy's slot (zeros elsewhere),
    d_inv_weight = dy . row (0 for a dropped copy)."""
    jp, tp, e, cap = _skewed_plans(name, 96, 23)
    rng = np.random.default_rng(24)
    d = 24
    eo = rng.standard_normal((e * cap, d)).astype(np.float32)
    dy = rng.standard_normal((96, d)).astype(np.float32)
    _, vjp = jax.vjp(_jax_combine(jp.inv_slot, jnp.float32), jnp.asarray(eo),
                     jp.inv_weight)
    want_eo, want_w = (np.asarray(x) for x in vjp(jnp.asarray(dy)))
    got_eo, got_w = moe_combine_backward_plain(
        tp.inv_slot, tp.inv_weight, torch.from_numpy(eo),
        torch.from_numpy(dy))
    assert got_eo.shape == eo.shape and got_w.shape == tp.inv_slot.shape
    np.testing.assert_allclose(got_eo.numpy(), want_eo, rtol=1e-6,
                               atol=1e-6 * np.abs(want_eo).max())
    assert float(np.abs(got_w.numpy() - want_w).max()) \
        <= 1e-5 * np.abs(want_w).max()
    dropped = (tp.inv_slot < 0).numpy()
    assert dropped.any() and not got_w.numpy()[dropped].any()
    empty = (tp.token_idx < 0).numpy()
    assert empty.any() and not got_eo.numpy()[empty].any()


def test_moe_backward_plain_rounds_as_the_kernel_does():
    """bf16: d_tokens sums in fp32 and rounds once; d_expert_out is the fp32
    product w * dy rounded once (the CUDA kernel's __fmul_rn, then one
    cast)."""
    rng = np.random.default_rng(25)
    slots = torch.tensor([[0, 2], [1, -1], [-1, -1]], dtype=torch.int32)
    d_slots = torch.from_numpy(rng.standard_normal((4, 16)).astype(
        np.float32)).to(torch.bfloat16)
    got = moe_gather_backward_plain(slots, d_slots)
    want = (d_slots[0].float() + d_slots[2].float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[0], want) and torch.equal(got[1], d_slots[1])
    assert not got[2].any()
    w = torch.tensor([[0.3, 0.7], [0.9, 0.0], [0.0, 0.0]])
    dy = torch.from_numpy(rng.standard_normal((3, 16)).astype(
        np.float32)).to(torch.bfloat16)
    d_eo, d_w = moe_combine_backward_plain(slots, w, d_slots, dy)
    assert d_eo.dtype == torch.bfloat16 and d_w.dtype == torch.float32
    for t, j in ((0, 0), (0, 1), (1, 0)):
        s = int(slots[t, j])
        assert torch.equal(d_eo[s], (w[t, j] * dy[t].float()).to(
            torch.bfloat16))
    assert not d_eo[3].any()                      # no copy points at slot 3
    assert float(d_w[1, 1]) == 0.0 and not d_w[2].any()


def _plan_duality(plan, t):
    """Each filled slot is the inv_slot of exactly one kept copy, of the
    token it holds; no kept copy points at an empty slot; a dropped copy
    has weight 0."""
    token_idx = plan.token_idx.numpy()
    inv_slot = plan.inv_slot.numpy()
    tt, jj = np.nonzero(inv_slot >= 0)
    kept = inv_slot[tt, jj]
    assert len(np.unique(kept)) == len(kept)
    np.testing.assert_array_equal(token_idx[kept], tt)
    filled = np.nonzero(token_idx >= 0)[0]
    np.testing.assert_array_equal(np.sort(kept), filled)
    assert ((token_idx >= -1) & (token_idx < t)).all()
    assert not plan.inv_weight.numpy()[inv_slot < 0].any()


@pytest.mark.parametrize("t,e,k,cf", [(1, 4, 1, 1.0), (37, 8, 2, 0.5),
                                      (96, 16, 4, 1.25), (64, 160, 6, 1.0),
                                      (200, 4, 2, 3.0)])
def test_dispatch_plan_duality(t, e, k, cf):
    m = MoEConfig(num_experts=e, experts_per_token=k, expert_d_ff=8,
                  capacity_factor=cf)
    rng = np.random.default_rng(t + e)
    probs = torch.from_numpy(_softmax(rng.standard_normal((t, e)) * 2
                                      + np.linspace(-2, 2, e)))
    _plan_duality(moe.moe_dispatch_plan(probs, m, moe.capacity(t, m)), t)


def test_dispatch_plan_duality_property():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=60, deadline=None, derandomize=True)
    @hyp.given(t=st.integers(1, 80), e=st.integers(1, 24),
               k=st.integers(1, 6), cap=st.integers(1, 40),
               ties=st.booleans(), seed=st.integers(0, 2 ** 31 - 1))
    def prop(t, e, k, cap, ties, seed):
        k = min(k, e)
        m = MoEConfig(num_experts=e, experts_per_token=k, expert_d_ff=8)
        rng = np.random.default_rng(seed)
        logits = rng.standard_normal((t, e)) * 3
        if ties:                                  # many exact ties
            logits = np.round(logits)
        probs = torch.from_numpy(_softmax(logits))
        _plan_duality(moe.moe_dispatch_plan(probs, m, cap), t)

    prop()


def test_moe_ops_need_the_other_stream_under_grad():
    """Under autograd the gather needs inv_slot and the combine token_idx
    (their backwards read them); without grad neither is asked for."""
    tokens = torch.randn((4, 8), requires_grad=True)
    idx = torch.tensor([0, 3, -1, 1], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="inv_slot"):
        moe_gather(idx, tokens)
    rows = torch.randn((4, 8), requires_grad=True)
    slots = torch.tensor([[0, 2], [1, -1]], dtype=torch.int32)
    w = torch.rand((2, 2))
    with pytest.raises(RuntimeError, match="token_idx"):
        moe_combine(slots, w, rows)
    with torch.no_grad():
        moe_gather(idx, tokens)
        moe_combine(slots, w, rows)


def test_moe_functions_on_cpu_match_autograd_of_the_plain_forward():
    """On the CPU the autograd Functions' backwards (the plain backwards)
    give what autograd of the plain forwards gives."""
    from repro_torch.kernels.moe_dispatch import MoECombineFn, MoEGatherFn
    _, tp, e, cap = _skewed_plans("deepseek-reduced", 64, 26)
    rng = np.random.default_rng(27)
    d = 20
    xt = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32))
    eo = torch.from_numpy(rng.standard_normal((e * cap, d)).astype(
        np.float32))
    a = [x.clone().requires_grad_() for x in (xt, eo, tp.inv_weight)]
    b = [x.clone().requires_grad_() for x in (xt, eo, tp.inv_weight)]
    g1 = ops.moe_gather_op(tp.token_idx, a[0], inv_slot=tp.inv_slot)
    c1 = ops.moe_combine_op(tp.inv_slot, a[2], a[1], token_idx=tp.token_idx)
    assert type(g1.grad_fn).__name__ == MoEGatherFn.__name__ + "Backward"
    assert type(c1.grad_fn).__name__ == MoECombineFn.__name__ + "Backward"
    g2 = moe_gather_plain(tp.token_idx, b[0])
    c2 = moe_combine_plain(tp.inv_slot, b[2], b[1])
    dg = torch.from_numpy(rng.standard_normal(g1.shape).astype(np.float32))
    dc = torch.from_numpy(rng.standard_normal(c1.shape).astype(np.float32))
    torch.autograd.backward([g1, c1], [dg, dc])
    torch.autograd.backward([g2, c2], [dg, dc])
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b"])
def test_moe_ffn_grads_match_jax(arch):
    """The layer's gradients (router, experts, shared experts and the input)
    through the ops' Functions against jax.vjp of the reference's layer, in
    fp32: each within 1e-4 of its largest reference entry."""
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype="float32")
    params = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(5),
                                                    jcfg))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    assert _margin(x, params["router"], jcfg.moe.experts_per_token) > 1e-4
    dy = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux, _ = jmoe.moe_ffn(p, xx, jcfg)
        return jnp.sum(y * jnp.asarray(dy)) + aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, copy=True))
                      .requires_grad_(), params)
    tx = torch.from_numpy(x).requires_grad_()
    y, aux, _ = moe.moe_ffn(tp, tx, tcfg)
    (y * torch.from_numpy(dy)).sum().add(aux).backward()
    pairs = [(tx.grad, jg_x)] + [
        (a.grad, b) for a, b in zip(jax.tree.leaves(tp),
                                    jax.tree.leaves(jg_p))]
    for got, want in pairs:
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-4 * np.abs(want).max() + 1e-12, err
