"""Port parity: prefill caches and the decode step of the attention-only archs.

The five attention-only configs (reduced) run with the reference's own
weights, converted through numpy by ``params_from_jax``:

* ``prefill`` (bf16, the configs' default): the caches' position tags
  exactly, K/V within rtol = atol = 3e-2 (a few bf16 ulps at the values'
  size), the last logits within 6e-2, as the prefill forward's tests hold
  them;
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
from repro_torch.models.attention import init_cache  # noqa: E402
from repro_torch.models.transformer import init_decode_caches  # noqa: E402

ARCHS = ["qwen2.5-3b", "qwen3-14b", "gemma3-12b", "starcoder2-15b",
         "dbrx-132b"]
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


def _views(caches):
    """(name, view) of every layer cache, prefix then slots."""
    for i, c in enumerate(caches["prefix"]):
        yield f"prefix{i}", c
    for j, c in enumerate(caches["slots"]):
        yield f"slot{j}", c


def _assert_caches(tc, jc, tol):
    tviews, jviews = list(_views(tc)), list(_views(jc))
    assert [n for n, _ in tviews] == [n for n, _ in jviews]
    for (name, t), (_, j) in zip(tviews, jviews):
        np.testing.assert_array_equal(t.kv_pos.numpy(),
                                      np.asarray(j.kv_pos), err_msg=name)
        for a, b in ((t.k, j.k), (t.v, j.v)):
            assert tuple(a.shape) == b.shape, name
            np.testing.assert_allclose(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_match_jax(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _weights(jcfg, tcfg)
    tokens = _tokens(1)
    jl, js = jprefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg, MAX_LEN)
    tl, ts = prefill(tp, {"tokens": torch.from_numpy(tokens)}, tcfg, MAX_LEN)
    assert isinstance(ts, DecodeState)
    assert ts.cur_pos.dtype == torch.int32
    np.testing.assert_array_equal(ts.cur_pos.numpy(), np.asarray(js.cur_pos))
    _assert_caches(ts.caches, js.caches, 3e-2)
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl.astype(jnp.float32)),
                               rtol=6e-2, atol=6e-2)
    if arch == "gemma3-12b":      # the local layers hold a ring of 16
        local = ts.caches["slots"][0]
        assert local.kv_pos.shape == (tcfg.num_periods, B, 16)
        assert sorted(local.kv_pos[0, 0].tolist()) == list(range(S - 16, S))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_from_the_same_state(arch):
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = _weights(jcfg, tcfg)
    tokens = _tokens(2)
    _, js = jprefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg, MAX_LEN)
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
    assert int(ts.caches["slots"][0].kv_pos.max()) == S


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
    tokens = torch.from_numpy(_tokens(5, s=s + 1))
    full, _, _, _ = forward(params, {"tokens": tokens}, cfg)
    _, state = prefill(params, {"tokens": tokens[:, :s]}, cfg, max_len=64)
    step, _ = decode_step(params, tokens[:, s], state, cfg)
    np.testing.assert_allclose(step.float().numpy(),
                               full[:, s].float().numpy(), rtol=0.08,
                               atol=0.08)


def test_decode_caches_layout_and_what_is_not_ported():
    cfg = get_config("gemma3-12b", reduced=True)
    caches = init_decode_caches(cfg, 3, 40, device="cpu")
    assert caches["prefix"] == []
    local, full = caches["slots"][0], caches["slots"][-1]
    assert local.k.shape == (cfg.num_periods, 3, 16, 2, 24)
    assert full.k.shape == (cfg.num_periods, 3, 40, 2, 24)
    assert full.k.dtype == torch.bfloat16
    assert bool((full.kv_pos == -1).all()) and not full.k.any()
    with pytest.raises(NotImplementedError, match="item 14"):
        init_cache(get_config("deepseek-v2-236b", reduced=True), 1, 8, "attn",
                   device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        init_decode_caches(get_config("mamba2-780m", reduced=True), 1, 8,
                           device="cpu")
