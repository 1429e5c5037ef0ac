"""Port parity: prefill caches and the decode step of every arch.

The ten configs (reduced) run with the reference's own weights, converted
through numpy by ``params_from_jax``; seamless-m4t-medium gets stub encoder
frames and phi-3-vision-4.2b a stub patch prefix, both from numpy seeds:

* ``prefill`` (bf16, the configs' default): the caches' position tags
  exactly, K/V (MLA's latents, Mamba's conv inputs and fp32 state, the
  cross-attention K/V) within rtol = atol = 3e-2 (a few bf16 ulps at the
  values' size), the last logits within 6e-2, as the prefill forward's
  tests hold them. Each package routes its MoE layers on its own, except
  in jamba-v0.1-52b: its eight layers take bf16 rounding further than
  that tolerance in the reference itself (its bf16 logits are about 0.1
  from its own fp32 ones, and so are the port's), and a top-k choice in
  its second layer lies near a tie that bf16 rounding flips. Its caches
  are held in fp32 within 1e-4, and its bf16 prefill against the
  reference's fp32 one, no further than the reference's own bf16 prefill
  is; in both its port replays the reference's dispatch plans (both run
  their periods unrolled, the same arithmetic), so that the two differ
  by rounding only;
* ``decode_step`` from the reference's own prefilled state, turned into
  the port's by ``decode_state_from_jax`` (fp32 compute): logits within
  rtol = atol = 1e-4, the caches after the step within 1e-5 and their
  tags and ``cur_pos`` exactly;
* 20 chained steps of gemma3-12b (fp32), whose local layers keep a ring of
  16 slots that the steps wrap, held step by step;
* the reference's teacher-forcing check (``tests/test_models_smoke.py``):
  ``decode_step``'s logits at s equal ``forward``'s at s within
  rtol = atol = 0.08, in bf16, MoE capacity raised so nothing drops.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    DecodeState,
    decode_state_from_jax,
    decode_step,
    forward,
    init_params,
    params_from_jax,
    prefill,
)
from repro_torch.models.attention import KVCacheView, init_cache  # noqa: E402
from repro_torch.models.mamba import MambaCache  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    CrossCache,
    init_decode_caches,
)
from torch_moe_plans import moe_plans  # noqa: E402

ARCHS = ["qwen2.5-3b", "qwen3-14b", "gemma3-12b", "starcoder2-15b",
         "dbrx-132b", "deepseek-v2-236b", "mamba2-780m", "jamba-v0.1-52b",
         "seamless-m4t-medium", "phi-3-vision-4.2b"]
#: Prompts longer than gemma3-12b's reduced window (16), so its local
#: layers keep only the last 16 positions.
B, S, MAX_LEN = 2, 20, 48


def _cfgs(arch, dtype):
    return tuple(dataclasses.replace(get(arch, reduced=True),
                                     compute_dtype=dtype)
                 for get in (jget_config, get_config))


def _weights(jcfg, tcfg):
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")


def _tokens(seed, b=B, s=S, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


def _batch(cfg, tokens, seed=9):
    """numpy inputs: the tokens, and the stub frontend embeddings the arch
    takes (12 encoder frames; the config's patch prefix)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": tokens}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (tokens.shape[0], 12, cfg.d_model)).astype(np.float32)
    if cfg.prefix_len:
        out["prefix_embeds"] = rng.standard_normal(
            (tokens.shape[0], cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _views(caches):
    """(name, cache) of every layer cache: prefix, slots, then the
    cross-attention caches where there are any."""
    for key in ("prefix", "slots", "cross_prefix", "cross_slots"):
        for i, c in enumerate(caches.get(key, ())):
            yield f"{key}{i}", c


def _assert_caches(tc, jc, tol):
    """Same cache types, fields and shapes; tags exact, values within tol."""
    assert sorted(tc) == sorted(jc)
    tviews, jviews = list(_views(tc)), list(_views(jc))
    assert [n for n, _ in tviews] == [n for n, _ in jviews]
    for (name, t), (_, j) in zip(tviews, jviews):
        assert type(t).__name__ == type(j).__name__, name
        assert t._fields == j._fields, name
        for field, a, b in zip(t._fields, t, j):
            assert tuple(a.shape) == b.shape, (name, field)
            if field == "kv_pos":
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=name)
                continue
            if field == "state":         # Mamba's SSD state stays fp32
                assert a.dtype == torch.float32, name
            np.testing.assert_allclose(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                rtol=tol, atol=tol, err_msg=f"{name}.{field}")


#: Archs whose prefill caches are held in fp32, and whose port replays
#: the reference's MoE dispatch plans in prefill (see the module).
FP32_PREFILL = REPLAYED_PLANS = {"jamba-v0.1-52b"}


def _prefill_both(arch, dtype):
    """Both packages' prefill on the reference's weights: ((logits, state)
    of the reference, (logits, state) of the port)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _weights(jcfg, tcfg)
    batch = _batch(tcfg, _tokens(1))
    replay = contextlib.nullcontext()
    if arch in REPLAYED_PLANS:
        jcfg = dataclasses.replace(jcfg, scan_periods=False,
                                   remat_policy="none")
        replay = moe_plans(replay=True)
    with replay:
        return (jprefill(jp, _jax(batch), jcfg, MAX_LEN),
                prefill(tp, _torch(batch), tcfg, MAX_LEN))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_match_jax(arch):
    fp32 = arch in FP32_PREFILL
    tcfg = _cfgs(arch, "bfloat16")[1]
    (jl, js), (tl, ts) = _prefill_both(
        arch, "float32" if fp32 else "bfloat16")
    assert isinstance(ts, DecodeState)
    assert ts.cur_pos.dtype == torch.int32
    np.testing.assert_array_equal(ts.cur_pos.numpy(), np.asarray(js.cur_pos))
    tol = (1e-4, 1e-4) if fp32 else (3e-2, 6e-2)
    _assert_caches(ts.caches, js.caches, tol[0])
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl.astype(jnp.float32)),
                               rtol=tol[1], atol=tol[1])
    if arch == "gemma3-12b":      # the local layers hold a ring of 16
        local = ts.caches["slots"][0]
        assert local.kv_pos.shape == (tcfg.num_periods, B, 16)
        assert sorted(local.kv_pos[0, 0].tolist()) == list(range(S - 16, S))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _cache_errors(caches, want):
    """Max abs error of each cache field (of either package) against the
    reference's fp32 ``want``."""
    return [float(np.abs(_f32(a) - _f32(b)).max())
            for (_, t), (_, j) in zip(_views(caches), _views(want))
            for f, a, b in zip(t._fields, t, j) if f != "kv_pos"]


@pytest.mark.parametrize("arch", sorted(FP32_PREFILL))
def test_bf16_prefill_is_as_close_to_fp32_as_the_reference(arch):
    """The bf16 prefill of either package against the reference's fp32 one:
    the port's largest error in the logits, and over all its caches, is at
    most 1.5 times the reference's own. (Cache by cache the two bf16 errors
    scatter around each other, either up to 4 times the other.)"""
    (jl32, js32), _ = _prefill_both(arch, "float32")
    (jl, js), (tl, ts) = _prefill_both(arch, "bfloat16")
    ref_err = np.abs(_f32(jl) - _f32(jl32)).max()
    port_err = np.abs(_f32(tl) - _f32(jl32)).max()
    assert port_err <= 1.5 * ref_err, (port_err, ref_err)
    got = max(_cache_errors(ts.caches, js32.caches))
    ref = max(_cache_errors(js.caches, js32.caches))
    assert got <= 1.5 * ref, (got, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_from_the_same_state(arch):
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = _weights(jcfg, tcfg)
    _, js = jprefill(jp, _jax(_batch(tcfg, _tokens(2))), jcfg, MAX_LEN)
    ts = decode_state_from_jax(jax.tree.map(np.asarray, js), tcfg,
                               device="cpu")
    _assert_caches(ts.caches, js.caches, 0.0)
    nxt = _tokens(3, s=1)[:, 0]
    jl, js2 = jdecode_step(jp, jnp.asarray(nxt), js, jcfg)
    tl, ts2 = decode_step(tp, torch.from_numpy(nxt), ts, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(ts2.cur_pos.numpy(),
                                  np.asarray(js2.cur_pos))
    _assert_caches(ts2.caches, js2.caches, 1e-5)
    # The step wrote the state's caches in place and shares them.
    assert ts2.caches is ts.caches
    tags = [c.kv_pos for _, c in _views(ts.caches) if hasattr(c, "kv_pos")]
    assert all(int(t.max()) == S + tcfg.prefix_len for t in tags)


def test_gemma3_ring_wraps_over_20_chained_steps():
    jcfg, tcfg = _cfgs("gemma3-12b", "float32")
    jp, tp = _weights(jcfg, tcfg)
    tokens = _tokens(4, s=8)
    jl, js = jprefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg, MAX_LEN)
    tl, ts = prefill(tp, {"tokens": torch.from_numpy(tokens)}, tcfg, MAX_LEN)
    jstep = jax.jit(lambda p, t, s: jdecode_step(p, t, s, jcfg))
    for step in range(20):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
        # Both packages are fed the reference's greedy token.
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, js = jstep(jp, jnp.asarray(nxt), js)
        tl, ts = decode_step(tp, torch.from_numpy(nxt), ts, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    _assert_caches(ts.caches, js.caches, 1e-4)
    local = ts.caches["slots"][0].kv_pos
    assert sorted(local[0, 0].tolist()) == list(range(28 - 16, 28))
    assert int(ts.cur_pos[0]) == 28


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """decode_step's logits at position s == forward's logits at s."""
    cfg = get_config(arch, reduced=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    params = init_params(0, cfg, device="cpu")
    s = 16
    batch = _torch(_batch(cfg, _tokens(5, s=s + 1)))
    full, _, _, _ = forward(params, batch, cfg)
    tokens = batch["tokens"]
    _, state = prefill(params, dict(batch, tokens=tokens[:, :s]), cfg,
                       max_len=64)
    step, _ = decode_step(params, tokens[:, s], state, cfg)
    np.testing.assert_allclose(step.float().numpy(),
                               full[:, s].float().numpy(), rtol=0.08,
                               atol=0.08)


def test_decode_caches_layout_and_what_is_not_ported():
    """The decode caches of each kind of layer: ring-sized K/V, MLA's latent
    beside a zero-width V, Mamba's conv inputs and fp32 state (jamba's
    period mixes both), and cross-attention K/V only with encoder memory."""
    cfg = get_config("gemma3-12b", reduced=True)
    caches = init_decode_caches(cfg, 3, 40, device="cpu")
    assert caches["prefix"] == []
    local, full = caches["slots"][0], caches["slots"][-1]
    assert local.k.shape == (cfg.num_periods, 3, 16, 2, 24)
    assert full.k.shape == (cfg.num_periods, 3, 40, 2, 24)
    assert full.k.dtype == torch.bfloat16
    assert bool((full.kv_pos == -1).all()) and not full.k.any()

    mla = get_config("deepseek-v2-236b", reduced=True)
    lat = init_cache(mla, 1, 8, "attn", device="cpu")
    assert lat.k.shape == (1, 8, 1, 16 + 8) and lat.v.shape == (1, 8, 1, 0)
    caches = init_decode_caches(mla, 2, 8, device="cpu")
    assert isinstance(caches["prefix"][0], KVCacheView)
    assert caches["slots"][0].k.shape == (mla.num_periods - 1, 2, 8, 1, 24)

    mamba = get_config("mamba2-780m", reduced=True)
    (slot,) = init_decode_caches(mamba, 1, 8, device="cpu")["slots"]
    assert isinstance(slot, MambaCache)
    assert slot.conv.shape == (2, 1, 3, 128 + 2 * 16)
    assert slot.conv.dtype == torch.bfloat16
    assert slot.state.shape == (2, 1, 8, 16, 16)
    assert slot.state.dtype == torch.float32 and not slot.state.any()

    jamba = get_config("jamba-v0.1-52b", reduced=True)
    slots = init_decode_caches(jamba, 1, 8, device="cpu")["slots"]
    assert [type(c).__name__ for c in slots] == \
        ["MambaCache"] * 4 + ["KVCacheView"] + ["MambaCache"] * 3

    seamless = get_config("seamless-m4t-medium", reduced=True)
    assert set(init_decode_caches(seamless, 1, 8, device="cpu")) == \
        {"prefix", "slots"}
    params = init_params(0, seamless, device="cpu")
    memory = torch.zeros((1, 5, seamless.d_model), dtype=torch.bfloat16)
    caches = init_decode_caches(seamless, 1, 8, device="cpu", memory=memory,
                                params=params["stack"])
    (cross,) = caches["cross_slots"]
    assert isinstance(cross, CrossCache)
    assert cross.k.shape == (2, 1, 5, 4, 16) and caches["cross_prefix"] == []
