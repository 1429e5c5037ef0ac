"""Port parity over the rest of the reference's attention domain: the
reduced configs' head dims and the logit softcap.

The flash kernel takes (D, DV) of 16, 24, MLA's 24 over 16 and 32 (every
registered arch's reduced config) and a logit softcap on the card; on the
CPU the wrapper runs its plain version, which these tests hold against
the reference from seeded numpy inputs:

* ``flash_attention`` at each new pair and at 128, without a cap and with
  caps of 50 (which barely bites at these scores) and 5 (which does),
  against the reference's ``blockwise_attention(softcap=)``
  (``repro/models/attention.py``: the scores times D**-0.5, then
  c tanh(s / c), then the mask): causal, windowed and not causal, G 2 and
  G 1, rtol = atol = 2e-5 in fp32 and 2e-2 in bf16;
* ``flash_attention_backward_plain(softcap=)`` against ``jax.vjp`` of the
  same, each of dQ, dK, dV within 1e-5 of its largest reference entry
  (fp32), as ``tests/test_torch_head256.py`` holds it;
* ``_kernel_gap`` is None for every attention of the registered archs'
  reduced configs and for capped configs: nothing there raises on the
  card; head dim 80 and positions that do not count from 0 still have a
  gap;
* the reduced gemma3-12b with ``attn_logit_softcap=5.0`` on the
  reference's own weights through ``models/convert.py``: prefill logits
  (fp32 within 1e-4, bf16 within 6e-2) and the loss and every leaf's
  gradient (fp32: loss within 1e-5 relative, each leaf within 1e-4 of its
  largest entry; bf16: loss within 1e-3 and cosine >= 0.999), the
  tolerances of ``tests/test_torch_head256.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models.attention import blockwise_attention  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FLASH_SHAPES,
    bwd_design,
    flash_attention,
    flash_attention_backward_plain,
    flash_attention_plain,
    shape_key,
)
from repro_torch.models import params_from_jax, prefill  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.train import grads_and_metrics  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

DT = {"float32": (jnp.float32, torch.float32, 2e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
#: The reduced configs' (D, DV) pairs, and 128 and phi-3-vision's 96 for
#: the cap at a published width.
NARROW = [(16, 16), (24, 24), (24, 16), (32, 32)]
PAIRS = NARROW + [(128, 128), (96, 96)]
CAPS = [None, 50.0, 5.0]
#: H, KV, causal, window.
MASKS = [(4, 2, True, None), (2, 2, False, 16), (4, 2, True, 24)]
#: q is scaled so that the scores reach about +-10 and a cap of 5 bites.
Q_SCALE = 4.0


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _qkv(seed, b, s, h, kv, d, dv, do=False):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    out = [f(b, s, h, d) * Q_SCALE, f(b, s, kv, d), f(b, s, kv, dv)]
    return out + [f(b, s, h, dv)] if do else out


def test_flash_shapes_take_the_reduced_head_dims():
    for d, dv in NARROW:
        assert (d, dv) in FLASH_SHAPES
        assert bwd_design(d, dv, torch.bfloat16) == "tensor_core"
        assert bwd_design(d, dv, torch.float32) == "cuda_core"
    assert shape_key(24, 16, True) == "24/16 causal"
    assert shape_key(16, 16, False, 5.0) == "16 non-causal softcap"


# ---------------------------------------------------------------------------
# Flash at the reduced head dims and under the cap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", CAPS)
@pytest.mark.parametrize("h,kv,causal,window", MASKS)
@pytest.mark.parametrize("d,dv", PAIRS)
def test_flash_plain_matches_blockwise_attention(dtype, d, dv, h, kv,
                                                 causal, window, softcap):
    jd, td, tol = DT[dtype]
    q, k, v = _qkv(d + dv + h + (window or 0), 2, 64, h, kv, d, dv)
    want = blockwise_attention(*(jnp.asarray(x).astype(jd) for x in (q, k, v)),
                               causal=causal, window=window, q_block=16,
                               kv_block=32, softcap=softcap)
    got = flash_attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                          causal=causal, window=window, softcap=softcap)
    assert got.dtype == td and got.shape == (2, 64, h, dv)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_a_cap_of_5_bites_at_these_scores():
    """The cap changes the output well beyond the tolerances, so the tests
    above do hold its semantics."""
    q, k, v = map(torch.from_numpy, _qkv(0, 1, 64, 4, 2, 16, 16))
    capped = flash_attention(q, k, v, softcap=5.0)
    assert float((capped - flash_attention(q, k, v)).abs().max()) > 0.1


@pytest.mark.parametrize("softcap", CAPS)
@pytest.mark.parametrize("h,kv,causal,window", MASKS)
@pytest.mark.parametrize("d,dv", PAIRS)
def test_flash_backward_plain_matches_reference_vjp(d, dv, h, kv, causal,
                                                    window, softcap):
    q, k, v, do = _qkv(7 + d + h + kv, 1, 40, h, kv, d, dv, do=True)
    _, vjp = jax.vjp(lambda q, k, v: blockwise_attention(
        q, k, v, causal=causal, window=window, q_block=40, kv_block=40,
        softcap=softcap), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window, softcap=softcap,
                                     return_lse=True)
    got = flash_attention_backward_plain(tq, tk, tv, out, lse, tdo,
                                         causal=causal, window=window,
                                         softcap=softcap)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 1e-5 * float(np.abs(b).max()), (name, err)


def test_flash_backward_plain_matches_autograd_under_the_cap():
    """The explicit backward under a cap against autograd of the plain
    forward (whose tanh autograd differentiates), fp32, within 1e-5 of
    each reference's largest entry."""
    q, k, v, do = map(torch.from_numpy, _qkv(3, 2, 48, 4, 2, 24, 16,
                                             do=True))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(
        *leaves, causal=True, window=20, softcap=5.0), leaves, do)
    out, lse = flash_attention_plain(q, k, v, causal=True, window=20,
                                     softcap=5.0, return_lse=True)
    got = flash_attention_backward_plain(q, k, v, out, lse, do, causal=True,
                                         window=20, softcap=5.0)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("softcap", [0.0, -1.0])
def test_flash_refuses_a_cap_that_is_not_positive(softcap):
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="softcap"):
        flash_attention(q, q, q, softcap=softcap)


# ---------------------------------------------------------------------------
# Nothing registered raises on the card, reduced or capped
# ---------------------------------------------------------------------------

#: Every registered arch with an attention core (mamba2-780m has none).
ATTENTION_ARCHS = [a for a in list_archs() if a != "mamba2-780m"]


def _dims(cfg):
    if cfg.mla is not None:
        return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
                cfg.mla.v_head_dim)
    return (cfg.head_dim_, cfg.head_dim_)


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_kernel_gap_is_none_for_reduced_configs(arch):
    cfg = get_config(arch, reduced=True)
    dims = _dims(cfg)
    assert dims in NARROW
    pos = torch.arange(64, dtype=torch.int32)[None].expand(2, -1)
    assert tattn._kernel_gap(cfg, pos, *dims) is None
    capped = dataclasses.replace(cfg, attn_logit_softcap=50.0)
    assert tattn._kernel_gap(capped, pos, *dims) is None


@pytest.mark.parametrize("reduced", [False, True])
def test_kernel_gap_is_none_for_a_capped_gemma3(reduced):
    cfg = dataclasses.replace(get_config("gemma3-12b", reduced=reduced),
                              attn_logit_softcap=50.0)
    pos = torch.arange(64, dtype=torch.int32)[None]
    assert tattn._softcap(cfg) == 50.0
    assert tattn._kernel_gap(cfg, pos, *_dims(cfg)) is None


def test_kernel_gap_still_names_what_the_card_lacks():
    cfg = get_config("qwen2.5-3b", reduced=True)
    pos = torch.arange(64, dtype=torch.int32)[None]
    assert tattn._kernel_gap(cfg, pos, 80).startswith("head dim 80")
    assert tattn._kernel_gap(cfg, pos + 1, 16).startswith("positions")


def test_mla_takes_no_cap():
    cfg = dataclasses.replace(get_config("deepseek-v2-236b", reduced=True),
                              attn_logit_softcap=50.0)
    assert tattn._softcap(cfg) is None


# ---------------------------------------------------------------------------
# The reduced gemma3-12b under a cap of 5, against the reference
# ---------------------------------------------------------------------------

CAP = 5.0
B = 2


def _cfgs(dtype):
    return tuple(dataclasses.replace(get("gemma3-12b", reduced=True),
                                     compute_dtype=dtype,
                                     attn_logit_softcap=CAP)
                 for get in (jget_config, get_config))


def _weights(jcfg, tcfg):
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 6e-2)])
def test_capped_prefill_logits_match_jax(dtype, tol):
    jcfg, tcfg = _cfgs(dtype)
    assert tcfg.head_dim_ == 24 and tcfg.sliding_window == 16
    jp, tp = _weights(jcfg, tcfg)
    tokens = np.random.default_rng(1).integers(1, 512, (B, 40)).astype(
        np.int32)
    jl, _ = jprefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg, 64)
    tl, _ = prefill(tp, {"tokens": torch.from_numpy(tokens)}, tcfg, 64)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=tol, atol=tol)


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_capped_loss_and_every_gradient_match_jax(compute):
    jcfg, tcfg = _cfgs(compute)
    jp, tp = _weights(jcfg, tcfg)
    out = make_batch(DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                global_batch=B, seed=1, mean_doc_len=16), 0)
    nb = {k: out[k] for k in ("tokens", "labels", "loss_mask")}
    (jl, _), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in nb.items()}, jcfg)
    grads, metrics = grads_and_metrics(
        tp, {k: torch.from_numpy(v) for k, v in nb.items()}, tcfg, 1)
    want = flatten(params_from_jax(jax.tree.map(np.asarray, jg), tcfg,
                                   "cpu"))
    got = flatten(grads)
    assert set(got) == set(want)
    if compute == "float32":
        np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                                   rtol=1e-5)
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
