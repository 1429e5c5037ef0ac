"""Port parity: flash attention's plain version and the attention layer.

On the CPU ``flash_attention`` runs its plain PyTorch version; the Pallas
kernel runs in interpret mode with the parameters of
``tests/test_kernels.py``, and the tolerances are that file's:
rtol = atol = 2e-5 in float32 and 2e-2 in bfloat16 (the sums run in
another order). The port's ``blockwise_attention`` is held against the
reference's (softcap, a value head dim that differs, windows, positions
that do not start at 0), and the attention layer against the reference's
for the configurations the prefill path runs. ``tests/test_torch_cuda.py``
holds the CUDA kernel against the plain version on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jflash,
)
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)
from repro_torch.models import attention as tattn  # noqa: E402

I = dict(interpret=True)
DT = {"float32": (jnp.float32, torch.float32, 2e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, b, s, h, kv, d, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dv or d)).astype(np.float32)
    return q, k, v


def _both(arrays, dtype):
    jd, td, _ = DT[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,d,window", [
    pytest.param(4, 4, 128, None, id="4-4"),
    pytest.param(4, 2, 128, None, id="4-2"),
    (4, 4, 96, None),       # phi-3-vision's heads of 96, G 1
    (8, 2, 96, None),       # G 4
    (4, 4, 96, 48),         # a window across the Pallas blocks
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas(dtype, h, kv, d, window, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, 2, 256, h, kv, d), dtype)
    want = jflash(jq, jk, jv, causal=causal, window=window, q_block=128,
                  kv_block=128, **I)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DT[dtype][2]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _np(tref.flash_attention_ref(tq, tk, tv, causal=causal,
                                     window=window)),
        _np(jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                     window=window)),
        rtol=tol, atol=tol)


def test_flash_plain_sliding_window_matches_pallas():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 1, 256, 2, 2, 128), "float32")
    want = jflash(jq, jk, jv, causal=True, window=64, q_block=64,
                  kv_block=64, **I)
    got = flash_attention(tq, tk, tv, causal=True, window=64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("blocks", [(64, 128), (128, 64), (256, 256)])
def test_flash_plain_ignores_the_block_shape(blocks):
    qb, kb = blocks
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(4, 1, 256, 2, 2, 128), "float32")
    want = jflash(jq, jk, jv, q_block=qb, kv_block=kb, **I)
    got = ops.flash_attention_op(tq, tk, tv, q_block=qb, kv_block=kb)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16), (False, 16)])
@pytest.mark.parametrize("s,h,kv,d", [(200, 6, 2, 64), (37, 8, 8, 16)])
def test_flash_plain_matches_ref(causal, window, s, h, kv, d):
    """Lengths that no tile divides, any head dim, windows with and
    without the causal mask: the plain version against both oracles."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s, 2, s, h, kv, d), "float32")
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _np(tref.flash_attention_ref(tq, tk, tv, causal=causal,
                                     window=window)),
        _np(want), rtol=2e-5, atol=2e-5)


def test_flash_plain_row_without_keys_is_zero():
    """More queries than keys under a window: a row that sees no key is
    zeros (the kernel's rule; the reference's softmax would average V)."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 40, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    out = flash_attention_plain(q, k, k.clone(), causal=True, window=4)
    assert not out[0, 11:].any() and out[0, :11].abs().sum() > 0


def test_flash_on_cpu_runs_the_plain_version():
    _, (tq, tk, tv) = _both(_qkv(2, 1, 64, 4, 2, 32), "float32")
    before = build.launch_counts()
    assert torch.equal(flash_attention(tq, tk, tv, window=8),
                       flash_attention_plain(tq, tk, tv, window=8))
    assert build.launch_counts() == before


def test_flash_rejects_bad_inputs():
    _, (tq, tk, tv) = _both(_qkv(3, 1, 8, 4, 2, 16), "float32")
    with pytest.raises(TypeError):
        flash_attention(tq, tk.double(), tv)
    with pytest.raises(ValueError):
        flash_attention(tq, tk[:, :, :1].expand(1, 8, 3, 16), tv)
    with pytest.raises(ValueError):
        flash_attention(tq, tk, tv, window=0)


# ---------------------------------------------------------------------------
# blockwise_attention and the attention layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(),
    dict(softcap=5.0),
    dict(window=24),
    dict(causal=False, window=24),
    dict(dv=24),
    dict(offset=True, softcap=3.0, window=40),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_attention_matches_jax(case, dtype):
    b, s, h, kv, d = 2, 64, 4, 2, 32
    q, k, v = _qkv(6, b, s, h, kv, d, case.get("dv"))
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    kw = dict(causal=case.get("causal", True), window=case.get("window"),
              softcap=case.get("softcap"), q_block=16, kv_block=32)
    jpos = tpos = None
    if case.get("offset"):
        pos = (np.arange(s)[None, :] + np.array([[5], [100]])).astype(np.int32)
        jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    want = jattn.blockwise_attention(jq, jk, jv, q_positions=jpos,
                                     kv_positions=jpos, **kw)
    got = tattn.blockwise_attention(tq, tk, tv, q_positions=tpos,
                                    kv_positions=tpos, **kw)
    assert got.shape == (b, s, h, case.get("dv", d))
    tol = DT[dtype][2]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _layer(arch, dtype, **replace):
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               compute_dtype=dtype, **replace)
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype=dtype, **replace)
    params = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(1), jcfg))
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    return jcfg, tcfg, params, tparams


@pytest.mark.parametrize("arch,kind,replace", [
    ("dbrx-132b", "attn", {}),
    ("qwen3-14b", "attn", {}),                           # qk-norm
    ("qwen2.5-3b", "attn", {}),                          # qkv bias
    ("gemma3-12b", "local", {}),                         # window 16
    ("gemma3-12b", "attn", dict(attn_logit_softcap=30.0)),
])
def test_attention_layer_matches_jax(arch, kind, replace):
    jcfg, tcfg, params, tparams = _layer(arch, "float32", **replace)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    jy, jc = jattn.attention(params, jnp.asarray(x), jnp.asarray(pos), jcfg,
                             kind=kind, return_cache=True)
    ty, tc = tattn.attention(tparams, torch.from_numpy(x),
                             torch.from_numpy(pos.copy()), tcfg, kind=kind,
                             return_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


def test_attention_routes_the_core():
    """The flash op takes positions from 0, with or without a softcap; the
    rest runs the blockwise schedule on the CPU (and raises on the card)."""
    _, tcfg, _, tparams = _layer("dbrx-132b", "float32")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 16, tcfg.d_model)).astype(np.float32))
    calls = []
    real = ops.flash_attention_op

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    pos = torch.arange(16, dtype=torch.int32)[None]
    ops.flash_attention_op = spy
    try:
        tattn.attention(tparams, x, pos, tcfg)
        assert len(calls) == 1
        tattn.attention(tparams, x, pos + 3, tcfg)
        assert len(calls) == 1
        capped = dataclasses.replace(tcfg, attn_logit_softcap=10.0)
        tattn.attention(tparams, x, pos, capped)
        assert len(calls) == 2
    finally:
        ops.flash_attention_op = real
    assert tattn._kernel_gap(capped, pos, 128) is None
    assert tattn._kernel_gap(tcfg, pos + 3, 128).startswith("positions")
    assert tattn._kernel_gap(tcfg, pos, 80).startswith("head dim 80")
    assert tattn._kernel_gap(tcfg, pos, 192).startswith("head dim 192")
    assert tattn._kernel_gap(tcfg, pos, 128) is None
    assert tattn._kernel_gap(tcfg, pos, 96) is None
    assert tattn._kernel_gap(tcfg, pos, 192, 128) is None
