"""Port parity: MLA (multi-head latent attention) and flash at its head dims.

The reduced deepseek-v2-236b attention layer (4 heads, q_lora 32, kv_lora
16, nope 16 + rope 8 query/key heads, value heads of 16) runs on the
reference's own parameters (``init_attention``) and the same numpy input:

* ``_mla_attention`` (the expanded prefill form) and the latent cache it
  returns, within rtol = atol = 1e-4 in fp32 and 2e-2 in bf16 (a few bf16
  ulps at the outputs' size); positions from 0, so the core goes through
  the flash op;
* ``_mla_decode`` (the absorbed form) from one latent cache, chained over
  4 steps: outputs within 1e-4 (fp32) and 2e-2 (bf16), the latent written
  in place at slot ``pos % max_len`` with its tag;
* the latent cache's layout: (B, S, 1, kv_lora + rope) beside a
  (B, S, 1, 0) value placeholder;
* ``flash_attention_plain`` with a value head dim that differs (192 over
  128, and 24 over 16 as the reduced model has) against the reference's
  ``blockwise_attention``, and at head dims 96 and 192 (the two new
  shapes of the CUDA kernel) against the Pallas kernel in interpret mode,
  within rtol = atol = 2e-5 (fp32) and 2e-2 (bf16), ``tests/test_kernels.py``'s
  tolerances.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jflash,
)
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FLASH_SHAPES,
    flash_attention_plain,
)
from repro_torch.models import attention as tattn  # noqa: E402

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LAYER_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _layer(dtype):
    jcfg, tcfg = (dataclasses.replace(get("deepseek-v2-236b", reduced=True),
                                      compute_dtype=dtype)
                  for get in (jget_config, get_config))
    params = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(2), jcfg))
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    return jcfg, tcfg, params, tparams


def _x(cfg, b, s, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(x).astype(DT[dtype][0]),
            torch.from_numpy(x).to(DT[dtype][1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_matches_jax(dtype):
    jcfg, tcfg, params, tparams = _layer(dtype)
    jx, tx = _x(tcfg, 2, 32, dtype, 0)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    calls = []
    real = ops.flash_attention_op

    def spy(q, k, v, **kw):
        calls.append((q.shape[-1], v.shape[-1], kw.get("causal")))
        return real(q, k, v, **kw)

    ops.flash_attention_op = spy
    try:
        ty, tc = tattn.attention(tparams, tx, torch.from_numpy(pos.copy()),
                                 tcfg, return_cache=True)
    finally:
        ops.flash_attention_op = real
    jy, jc = jattn.attention(params, jx, jnp.asarray(pos), jcfg,
                             return_cache=True)
    m = tcfg.mla
    assert calls == [(m.qk_nope_head_dim + m.qk_rope_head_dim,
                      m.v_head_dim, True)]
    tol = LAYER_TOL[dtype]
    assert ty.dtype == DT[dtype][1]
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=tol, atol=tol)
    for name, a, b in zip(tc._fields, tc, jc):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax_from_the_same_cache(dtype):
    """A latent cache filled by a prefill of 10 positions (max_len 16),
    then 4 absorbed decode steps in both packages."""
    jcfg, tcfg, params, tparams = _layer(dtype)
    b, s, max_len = 2, 10, 16
    jx, _ = _x(tcfg, b, s, dtype, 1)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    _, lat = jattn.attention(params, jx, pos, jcfg, return_cache=True)
    jcache = jattn.init_cache(jcfg, b, max_len, "attn")
    jcache = jattn.KVCacheView(jcache.k.at[:, :s].set(lat.k), jcache.v,
                               jcache.kv_pos.at[:, :s].set(lat.kv_pos))
    tcache = tattn.KVCacheView(
        *(torch.tensor(_np(x)).to(DT[dtype][1]) for x in jcache[:2]),
        torch.tensor(np.asarray(jcache.kv_pos)))
    k_before = tcache.k
    tol = LAYER_TOL[dtype]
    for step in range(4):
        jxi, txi = _x(tcfg, b, 1, dtype, 10 + step)
        cur = np.full((b,), s + step, np.int32)
        jy, jcache = jattn.decode_attention(params, jxi, jcache,
                                            jnp.asarray(cur), jcfg)
        ty, out = tattn.decode_attention(tparams, txi, tcache,
                                         torch.from_numpy(cur), tcfg)
        assert out is tcache and out.k is k_before
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=tol, atol=tol,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(tcache.kv_pos.numpy(),
                                      np.asarray(jcache.kv_pos))
        np.testing.assert_allclose(_np(tcache.k), _np(jcache.k), rtol=tol,
                                   atol=tol, err_msg=f"step {step}")
    assert sorted(tcache.kv_pos[0].tolist()) == [-1] * 2 + list(range(14))


def test_mla_latent_cache_layout():
    _, tcfg, _, tparams = _layer("float32")
    m = tcfg.mla
    lat = m.kv_lora_rank + m.qk_rope_head_dim
    cache = tattn.init_cache(tcfg, 3, 12, "attn", device="cpu")
    assert cache.k.shape == (3, 12, 1, lat) and cache.k.dtype == tcfg.cdtype
    assert cache.v.shape == (3, 12, 1, 0)
    assert bool((cache.kv_pos == -1).all())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 6, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(6, dtype=torch.int32)[None]
    _, view = tattn.attention(tparams, x, pos, tcfg, return_cache=True)
    assert view.k.shape == (1, 6, 1, lat) and view.v.shape == (1, 6, 1, 0)
    # The latent is (c_kv normalised | k_rope rotated) of each position.
    c_kv, k_rope = tattn._mla_latent(tparams, x, pos, tcfg)
    assert torch.equal(view.k[:, :, 0, :m.kv_lora_rank], c_kv)
    assert torch.equal(view.k[:, :, 0, m.kv_lora_rank:], k_rope[:, :, 0])
    assert torch.equal(view.kv_pos, pos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,dv,h,kv,causal", [(192, 128, 4, 4, True),
                                              (24, 16, 4, 4, True),
                                              (192, 128, 4, 2, False)])
def test_flash_plain_value_dim_matches_blockwise(dtype, d, dv, h, kv,
                                                 causal):
    rng = np.random.default_rng(d + dv)
    q = rng.standard_normal((2, 96, h, d)).astype(np.float32)
    k = rng.standard_normal((2, 96, kv, d)).astype(np.float32)
    v = rng.standard_normal((2, 96, kv, dv)).astype(np.float32)
    jd, td = DT[dtype]
    want = jattn.blockwise_attention(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)), causal=causal,
        q_block=32, kv_block=32)
    got = flash_attention_plain(*(torch.from_numpy(a).to(td)
                                  for a in (q, k, v)), causal=causal)
    assert got.shape == (2, 96, h, dv) and got.dtype == td
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [96, 192])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_new_head_dims_match_pallas(dtype, d, causal):
    assert (d, 128 if d == 192 else d) in FLASH_SHAPES
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((1, 128, 4, d)).astype(np.float32)
               for _ in range(3))
    jd, td = DT[dtype]
    want = jflash(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                  causal=causal, q_block=64, kv_block=64, interpret=True)
    got = flash_attention_plain(*(torch.from_numpy(a).to(td)
                                  for a in (q, k, v)), causal=causal)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
