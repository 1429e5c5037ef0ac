"""Port parity: configs, layers, parameter shapes and the prefill forward.

The configs are plain data and must give the reference's numbers. The
forward runs the reduced dbrx-132b (2 layers of attention + MoE) with the
reference's own weights, converted through numpy by ``params_from_jax``:
logits, aux loss and the caches' k/v within rtol = atol = 1e-4 in fp32
compute. In bf16 (the config's default) the two frameworks round at other
places; logits, which reach about 4, are held within rtol = atol = 6e-2
(a few bf16 ulps of 2**-8 relative), the k/v caches within 3e-2 and aux
within 1e-3 relative. The bf16 case first asserts that both packages route
every token to the same expert slots in every MoE layer, so that a flipped
expert choice would show as such and not as a numeric difference.

The other five families (MLA, Mamba-2, the hybrid, the encoder-decoder
with stub frames and the VLM with a stub patch prefix, inputs from numpy
seeds) hold their fp32 logits, aux, caches and encoder memory within
rtol = atol = 1e-4, and their parameter trees match the reference's
shapes, the encoder stack included.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import param_shapes as jparam_shapes  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import (  # noqa: E402
    forward,
    init_params,
    param_shapes,
    params_from_jax,
)
from repro_torch.models import layers, moe  # noqa: E402
from torch_moe_plans import moe_plans  # noqa: E402


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", jlist_archs())
def test_config_matches(arch, reduced):
    assert list_archs() == jlist_archs()
    j, t = jget_config(arch, reduced=reduced), get_config(arch,
                                                          reduced=reduced)
    assert repr(_fields(t)) == repr(_fields(j))
    assert t.head_dim_ == j.head_dim_
    assert t.padded_vocab == j.padded_vocab
    assert t.num_periods == j.num_periods
    assert t.param_counts() == j.param_counts()
    assert t.cdtype == getattr(torch, str(j.cdtype))
    assert t.pdtype == getattr(torch, str(j.pdtype))


def test_dbrx_full_config_is_the_published_one():
    cfg = get_config("dbrx-132b")
    m = cfg.moe
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
            cfg.padded_vocab) == (6144, 48, 8, 128, 100352)
    assert (m.num_experts, m.experts_per_token, m.expert_d_ff,
            m.capacity_factor) == (16, 4, 10752, 1.25)
    assert moe.capacity(4 * 2048, m) * m.num_experts == 40960


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
        .numpy(), np.asarray(jlayers.rms_norm(jnp.asarray(x),
                                              jnp.asarray(w), 1e-6)),
        rtol=1e-6, atol=1e-6)
    pos = (np.arange(8)[None] + np.array([[0], [1000]])).astype(np.int32)
    for theta, frac in ((10000.0, 1.0), (500000.0, 0.5)):
        np.testing.assert_allclose(
            layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta=theta, fraction=frac).numpy(),
            np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          theta=theta, fraction=frac)),
            rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    for gated, act in ((True, "silu"), (False, "gelu"), (True, "gelu")):
        p = jax.tree.map(np.asarray, jlayers.init_mlp(
            jax.random.PRNGKey(0), 16, 24, jnp.float32, gated=gated))
        tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
        np.testing.assert_allclose(
            layers.mlp(tp, torch.from_numpy(h), act, torch.float32).numpy(),
            np.asarray(jlayers.mlp(p, jnp.asarray(h), act, jnp.float32)),
            rtol=1e-5, atol=1e-5)


def test_init_draws_the_reference_distributions():
    """Same shapes, dtypes and spread (trunc-normal on [-2, 2], scaled by
    fan-in ** -0.5) as the reference's init; the draws themselves differ."""
    big = dataclasses.replace(get_config("dbrx-132b", reduced=True),
                              d_model=256)
    p = init_params(0, big, device="cpu")
    jp = jinit(jax.random.PRNGKey(0),
               dataclasses.replace(jget_config("dbrx-132b", reduced=True),
                                   d_model=256))
    for a, b in ((p["stack"]["slots"][0][0]["mixer"]["wq"],
                  jp["stack"]["slots"][0]["mixer"]["wq"][0]),
                 (p["stack"]["slots"][0][1]["ffn"]["w_up"],
                  jp["stack"]["slots"][0]["ffn"]["w_up"][1]),
                 (p["embed"]["embedding"], jp["embed"]["embedding"])):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(float(a.std()), b.std(), rtol=0.05)
        np.testing.assert_allclose(float(a.abs().max()),
                                   np.abs(b).max(), rtol=0.05)
    q = init_params(torch.Generator().manual_seed(0), big, device="cpu")
    assert torch.equal(q["embed"]["unembed"], p["embed"]["unembed"])


@pytest.mark.parametrize("arch", ["dbrx-132b", "qwen3-14b", "gemma3-12b",
                                  "starcoder2-15b"])
def test_param_shapes_match(arch):
    cfg = get_config(arch, reduced=True)
    t = param_shapes(cfg)
    j = jparam_shapes(jget_config(arch, reduced=True))
    assert t["embed"].keys() == j["embed"].keys()
    for k in t["embed"]:
        assert tuple(t["embed"][k].shape) == j["embed"][k].shape
    assert len(t["stack"]["prefix"]) == len(j["stack"]["prefix"]) == 0
    for tslot, jslot in zip(t["stack"]["slots"], j["stack"]["slots"]):
        jflat = jax.tree_util.tree_flatten_with_path(jslot)[0]
        for period in tslot:
            tflat = jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda x: x.shape, period))[0]
            assert [p for p, _ in tflat] == [p for p, _ in jflat]
            for (_, ts), (_, jl) in zip(tflat, jflat):
                assert (cfg.num_periods,) + tuple(ts) == jl.shape
        assert len(tslot) == cfg.num_periods
    assert all(x.device.type == "meta" for x in jax.tree.leaves(
        t, is_leaf=lambda x: isinstance(x, torch.Tensor)))


# ---------------------------------------------------------------------------
# The prefill forward
# ---------------------------------------------------------------------------

def _run(arch, dtype, tokens, *, plans=None, extra=None):
    """The reference's forward and the port's on the same weights. With
    ``plans`` (a list), both run their periods unrolled and unscanned (the
    same arithmetic) so that each MoE layer's dispatch plan is recorded as
    ``(reference's, port's)``. ``extra`` adds numpy inputs to the batch
    (``frames``, ``prefix_embeds``)."""
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               compute_dtype=dtype)
    if plans is not None:
        jcfg = dataclasses.replace(jcfg, scan_periods=False,
                                   remat_policy="none")
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype=dtype)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    batch = dict(extra or {}, tokens=tokens)
    hooks = contextlib.nullcontext([]) if plans is None else moe_plans()
    with hooks as pairs:
        j = jforward(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                     return_caches=True)
        t = forward(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                    tcfg, return_caches=True)
    if plans is not None:
        plans.extend(pairs)
    return j, t


def _tokens(seed, vocab, b=2, s=16):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ["dbrx-132b", "qwen3-14b", "gemma3-12b"])
def test_forward_matches_jax_fp32(arch):
    tokens = _tokens(1, 512)
    (jl, jaux, jc, jmem), (tl, taux, tc, tmem) = _run(arch, "float32", tokens)
    assert jmem is None and tmem is None
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4,
                               atol=1e-4)
    assert len(tc["prefix"]) == len(jc["prefix"]) == 0
    for tview, jview in zip(tc["slots"], jc["slots"]):
        for a, b in zip(tview, jview):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                       rtol=1e-4, atol=1e-4)


def test_forward_matches_jax_bf16():
    plans = []
    (jl, jaux, jc, _), (tl, taux, tc, _) = _run(
        "dbrx-132b", "bfloat16", _tokens(2, 512), plans=plans)
    # Both route every token copy to the same slot in both MoE layers, so
    # the logits differ by rounding only, not by a flipped expert choice.
    assert len(plans) == 2
    for jplan, tplan in plans:
        np.testing.assert_array_equal(tplan.inv_slot.numpy(),
                                      np.asarray(jplan.inv_slot))
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl.astype(jnp.float32)),
                               rtol=6e-2, atol=6e-2)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-3)
    for tview, jview in zip(tc["slots"], jc["slots"]):
        for a, b in zip(tview[:2], jview[:2]):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b.astype(jnp.float32)),
                                       rtol=3e-2, atol=3e-2)
        np.testing.assert_array_equal(tview.kv_pos.numpy(),
                                      np.asarray(jview.kv_pos))


def test_forward_is_one_path_on_the_cpu():
    """The reduced model's head dim (16) is not one the CUDA kernel takes,
    yet on the CPU the core still goes through the flash op (its plain
    version), with the gather and the combine."""
    from repro_torch.kernels import ops
    seen = []
    names = ("flash_attention_op", "moe_gather_op", "moe_combine_op")
    real = {n: getattr(ops, n) for n in names}
    for n in names:
        setattr(ops, n, lambda *a, _n=n, **kw: (seen.append(_n),
                                                real[_n](*a, **kw))[1])
    try:
        cfg = get_config("dbrx-132b", reduced=True)
        p = init_params(0, cfg, device="cpu")
        logits, aux, caches, _ = forward(
            p, {"tokens": torch.from_numpy(_tokens(3, 512))}, cfg)
    finally:
        for n in names:
            setattr(ops, n, real[n])
    assert caches is None and torch.isfinite(logits.float()).all()
    assert sorted(seen) == sorted(names * cfg.num_layers)


FAMILIES = ["deepseek-v2-236b", "mamba2-780m", "jamba-v0.1-52b",
            "seamless-m4t-medium", "phi-3-vision-4.2b"]


def _extra(arch, b=2, seed=4):
    """The stub frontend inputs of an arch: 12 encoder frames, or the
    config's patch prefix."""
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"frames": rng.standard_normal(
            (b, 12, cfg.d_model)).astype(np.float32)}
    if cfg.prefix_len:
        return {"prefix_embeds": rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model)).astype(np.float32)}
    return {}


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_forward_matches_jax_fp32(arch):
    tokens = _tokens(5, 512, s=32)
    (jl, jaux, jc, jmem), (tl, taux, tc, tmem) = _run(
        arch, "float32", tokens, extra=_extra(arch))
    # The prefix's positions are cut from the logits.
    assert tl.shape == jl.shape == (2, 32, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4,
                               atol=1e-4)
    assert (tmem is None) == (jmem is None)
    if jmem is not None:
        np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem),
                                   rtol=1e-4, atol=1e-4)
    views = list(zip(tc["prefix"], jc["prefix"])) + \
        list(zip(tc["slots"], jc["slots"]))
    assert len(views) == len(jc["prefix"]) + len(jc["slots"])
    for tview, jview in views:
        assert type(tview).__name__ == type(jview).__name__
        for a, b in zip(tview, jview):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_param_shapes_match(arch):
    cfg = get_config(arch, reduced=True)
    t = param_shapes(cfg)
    j = jparam_shapes(jget_config(arch, reduced=True))
    assert sorted(t) == sorted(j)
    for key in t:
        if key not in ("stack", "encoder"):
            assert jax.tree.map(lambda x: tuple(x.shape), t[key]) == \
                jax.tree.map(lambda x: x.shape, j[key])
            continue
        assert len(t[key]["prefix"]) == len(j[key]["prefix"])
        for tp, jpp in zip(t[key]["prefix"], j[key]["prefix"]):
            assert jax.tree.map(lambda x: tuple(x.shape), tp) == \
                jax.tree.map(lambda x: x.shape, jpp)
        for tslot, jslot in zip(t[key]["slots"], j[key]["slots"]):
            want = jax.tree.map(lambda x: x.shape[1:], jslot)
            for period in tslot:
                assert jax.tree.map(lambda x: tuple(x.shape), period) == want
            assert {x.shape[0] for x in jax.tree.leaves(jslot)} == \
                {len(tslot)}
