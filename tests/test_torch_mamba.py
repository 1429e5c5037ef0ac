"""Port parity: the Mamba-2 SSD layer and its decode step.

The reduced mamba2-780m (chunk 32, d_state 16) and jamba-v0.1-52b (chunk
32, d_state 8) mixers run on the reference's own parameters
(``init_mamba``) and the same numpy input, in fp32 compute:

* ``mamba_layer`` at 1 and 3 chunks: the output within rtol = atol = 1e-4,
  the final SSD state and the conv tail within 1e-5 (the chunked sums run
  in another order);
* ``mamba_decode`` chained over 8 steps from the reference's cache: each
  step's output within 1e-4, the cache after each step within 1e-5, and
  written in place;
* the decode steps continue the full pass: a prefill of 24 tokens and 8
  steps give the layer's output over 32 within 1e-4 (the port alone);
* bf16 compute at 3 chunks within rtol = atol = 3e-2 (a few bf16 ulps).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mamba  # noqa: E402

ARCHS = ["mamba2-780m", "jamba-v0.1-52b"]


def _setup(arch, dtype="float32"):
    jcfg, tcfg = (dataclasses.replace(get(arch, reduced=True),
                                      compute_dtype=dtype)
                  for get in (jget_config, get_config))
    jp = jax.tree.map(np.asarray, jmamba.init_mamba(jax.random.PRNGKey(3),
                                                    jcfg))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


def _x(cfg, b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_layer_matches_jax(arch, chunks):
    jcfg, tcfg, jp, tp = _setup(arch)
    x = _x(tcfg, 2, chunks * tcfg.ssm.chunk)
    jy, jc = jmamba.mamba_layer(jp, jnp.asarray(x), jcfg, return_cache=True)
    ty, tc = mamba.mamba_layer(tp, torch.from_numpy(x), tcfg,
                               return_cache=True)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-4, atol=1e-4)
    assert tc.state.dtype == torch.float32
    assert tuple(tc.state.shape) == jc.state.shape
    assert tuple(tc.conv.shape) == jc.conv.shape
    np.testing.assert_allclose(_np(tc.state), _np(jc.state), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(tc.conv), _np(jc.conv), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_layer_matches_jax_bf16(arch):
    jcfg, tcfg, jp, tp = _setup(arch, "bfloat16")
    x = _x(tcfg, 2, 3 * tcfg.ssm.chunk, seed=1)
    jy = jmamba.mamba_layer(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    ty = mamba.mamba_layer(tp, torch.from_numpy(x).bfloat16(), tcfg)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_decode_chained_over_8_steps(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    x = _x(tcfg, 3, tcfg.ssm.chunk, seed=2)
    _, jc = jmamba.mamba_layer(jp, jnp.asarray(x), jcfg, return_cache=True)
    tc = mamba.MambaCache(*(torch.from_numpy(np.array(a)) for a in jc))
    steps = _x(tcfg, 3, 8, seed=3)
    conv, state = tc.conv, tc.state
    for i in range(8):
        xi = steps[:, i:i + 1]
        jy, jc = jmamba.mamba_decode(jp, jnp.asarray(xi), jc, jcfg)
        ty, out = mamba.mamba_decode(tp, torch.from_numpy(xi), tc, tcfg)
        assert out is tc and out.conv is conv and out.state is state
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {i}")
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_decode_continues_the_full_pass(arch):
    _, tcfg, _, tp = _setup(arch)
    x = torch.from_numpy(_x(tcfg, 2, 32, seed=4))
    full = mamba.mamba_layer(tp, x, tcfg)
    head, cache = mamba.mamba_layer(tp, x[:, :24], tcfg, return_cache=True)
    np.testing.assert_allclose(_np(head), _np(full[:, :24]), rtol=1e-4,
                               atol=1e-4)
    for i in range(24, 32):
        y, cache = mamba.mamba_decode(tp, x[:, i:i + 1], cache, tcfg)
        np.testing.assert_allclose(_np(y), _np(full[:, i:i + 1]), rtol=1e-4,
                                   atol=1e-4, err_msg=f"position {i}")


def test_init_mamba_draws_the_reference_parameters():
    """The same tree and shapes; A_log, D and dt_bias in fp32 even under
    bf16 parameters, A_log and D the reference's (A_log = log(1..H) within
    an fp32 ulp: the two logs round apart), and softplus(dt_bias) within
    [dt_min, dt_max]."""
    jcfg = dataclasses.replace(jget_config("mamba2-780m", reduced=True),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(get_config("mamba2-780m", reduced=True),
                               param_dtype="bfloat16")
    jp = jmamba.init_mamba(jax.random.PRNGKey(0), jcfg)
    tp = mamba.init_mamba(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape),
                                   str(a.dtype).removeprefix("torch.")),
                        tp) == \
        jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=2e-7, atol=0)
    np.testing.assert_array_equal(tp["D"].numpy(), np.asarray(jp["D"]))
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    s = tcfg.ssm
    assert bool((dt >= s.dt_min * 0.999).all())
    assert bool((dt <= s.dt_max * 1.001).all())
    with pytest.raises(ValueError, match="chunk"):
        mamba.mamba_layer(mamba.init_mamba(None, tcfg, "meta"),
                          torch.zeros((1, 40, tcfg.d_model), device="meta"),
                          tcfg)
