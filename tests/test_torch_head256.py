"""Port parity at head dim 256: gemma3-12b's published attention width.

The flash kernel takes (D, DV) = (256, 256) on the card; on the CPU the
wrapper runs its plain version, which these tests hold against the
reference from seeded numpy inputs:

* ``flash_attention`` at (256, 256) against the reference's
  ``blockwise_attention`` (``repro/models/attention.py``) and its Pallas
  ``flash_attention`` in interpret mode: causal, windowed, not causal, at
  G 2 and G 1, rtol = atol = 2e-5 in fp32 and 2e-2 in bf16, the
  tolerances of ``tests/test_torch_flash_attention.py``;
* ``flash_attention_backward_plain`` at (256, 256) against ``jax.vjp`` of
  ``blockwise_attention``, each of dQ, dK, dV within 1e-5 of its largest
  reference entry (fp32), as ``tests/test_torch_flash_backward.py`` does;
* the reduced gemma3-12b widened to head dim 256 (6 layers, 2 query heads
  over 1 KV head, window 16) on the reference's own weights through
  ``models/convert.py``: prefill logits (fp32 within 1e-4, bf16 within
  6e-2, as ``tests/test_torch_decode.py`` holds them), 20 decode steps
  that wrap the local layers' ring of 16 (fp32, 1e-4 each step), and the
  loss and every leaf's gradient (fp32: loss within 1e-5 relative, each
  leaf within 1e-4 of its largest entry; bf16: loss within 1e-3 and
  cosine >= 0.999, as ``tests/test_torch_train.py`` holds them);
* ``_kernel_gap`` is None for every attention of the registered configs at
  their published head dims, positions from 0: nothing there raises on the
  card.
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
from repro.models import decode_step as jdecode_step  # noqa: E402
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
)
from repro_torch.models import (  # noqa: E402
    decode_step,
    params_from_jax,
    prefill,
)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.train import grads_and_metrics  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

D = 256
DT = {"float32": (jnp.float32, torch.float32, 2e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _qkv(seed, b, s, h, kv, do=False):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    out = [f(b, s, h, D), f(b, s, kv, D), f(b, s, kv, D)]
    return out + [f(b, s, h, D)] if do else out


def test_flash_shapes_take_head_dim_256():
    assert (D, D) in FLASH_SHAPES
    assert bwd_design(D, D, torch.bfloat16) == "tensor_core"
    assert bwd_design(D, D, torch.float32) == "cuda_core"


# ---------------------------------------------------------------------------
# Flash at (256, 256)
# ---------------------------------------------------------------------------

#: H, KV, causal, window.
FLASH_CASES = [
    (4, 2, True, None),      # G 2, causal (gemma3's global layers)
    (4, 2, True, 24),        # G 2, windowed (its local layers)
    (4, 2, False, None),     # not causal
    (2, 2, True, None),      # G 1
    (2, 2, False, 24),       # G 1, windowed, not causal
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,causal,window", FLASH_CASES)
def test_flash_plain_matches_blockwise_attention(dtype, h, kv, causal,
                                                 window):
    jd, td, tol = DT[dtype]
    q, k, v = _qkv(h + kv + (window or 0), 2, 64, h, kv)
    want = blockwise_attention(*(jnp.asarray(x).astype(jd) for x in (q, k, v)),
                               causal=causal, window=window, q_block=16,
                               kv_block=32)
    got = flash_attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                          causal=causal, window=window)
    assert got.dtype == td and got.shape == (2, 64, h, D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_at_256(causal):
    q, k, v = _qkv(3, 1, 128, 4, 2)
    want = jflash(*map(jnp.asarray, (q, k, v)), causal=causal, q_block=64,
                  kv_block=64, interpret=True)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("h,kv,causal,window", FLASH_CASES)
def test_flash_backward_plain_matches_reference_vjp(h, kv, causal, window):
    q, k, v, do = _qkv(7 + h + kv, 1, 40, h, kv, do=True)
    _, vjp = jax.vjp(lambda q, k, v: blockwise_attention(
        q, k, v, causal=causal, window=window, q_block=40, kv_block=40),
        *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window, return_lse=True)
    got = flash_attention_backward_plain(tq, tk, tv, out, lse, tdo,
                                         causal=causal, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 1e-5 * float(np.abs(b).max()), (name, err)


# ---------------------------------------------------------------------------
# gemma3-12b, reduced, at its published head dim
# ---------------------------------------------------------------------------

#: The reduced config's depth (one period: 5 local + 1 global) and window
#: (16), its widths but for the heads: 2 query heads over 1 KV head of 256.
WIDE = dict(head_dim=D, num_heads=2, num_kv_heads=1)
B, S, MAX_LEN, STEPS = 2, 8, 48, 20


def _cfgs(dtype):
    return tuple(dataclasses.replace(get("gemma3-12b", reduced=True),
                                     compute_dtype=dtype, **WIDE)
                 for get in (jget_config, get_config))


def _weights(jcfg, tcfg):
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")


def test_reduced_gemma3_runs_head_dim_256():
    jcfg, tcfg = _cfgs("float32")
    assert tcfg.head_dim_ == D and tcfg.num_layers == 6 \
        and tcfg.sliding_window == 16
    pos = torch.arange(S, dtype=torch.int32)[None]
    assert tattn._kernel_gap(tcfg, pos, tcfg.head_dim_) is None


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 6e-2)])
def test_prefill_logits_match_jax(dtype, tol):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _weights(jcfg, tcfg)
    tokens = np.random.default_rng(1).integers(1, 512, (B, 20)).astype(
        np.int32)
    jl, _ = jprefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg, MAX_LEN)
    tl, _ = prefill(tp, {"tokens": torch.from_numpy(tokens)}, tcfg, MAX_LEN)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=tol, atol=tol)


def test_decode_wraps_the_ring_over_20_steps():
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _weights(jcfg, tcfg)
    tokens = np.random.default_rng(4).integers(1, 512, (B, S)).astype(
        np.int32)
    jl, js = jprefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg, MAX_LEN)
    tl, ts = prefill(tp, {"tokens": torch.from_numpy(tokens)}, tcfg, MAX_LEN)
    jstep = jax.jit(lambda p, t, s: jdecode_step(p, t, s, jcfg))
    for step in range(STEPS):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
        # Both packages are fed the reference's greedy token.
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, js = jstep(jp, jnp.asarray(nxt), js)
        tl, ts = decode_step(tp, torch.from_numpy(nxt), ts, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    local = ts.caches["slots"][0]
    assert local.k.shape[-1] == D
    assert sorted(local.kv_pos[0, 0].tolist()) == list(
        range(S + STEPS - 16, S + STEPS))
    assert int(ts.cur_pos[0]) == S + STEPS


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_loss_and_every_gradient_match_jax(compute):
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


# ---------------------------------------------------------------------------
# Nothing registered raises on the card
# ---------------------------------------------------------------------------

#: Every registered arch with an attention core (mamba2-780m has none).
ATTENTION_ARCHS = ["qwen2.5-3b", "qwen3-14b", "gemma3-12b", "starcoder2-15b",
                   "dbrx-132b", "deepseek-v2-236b", "jamba-v0.1-52b",
                   "seamless-m4t-medium", "phi-3-vision-4.2b"]


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_kernel_gap_is_none_at_published_widths(arch):
    """Positions from 0 at (o)'s prompt length: the flash kernel takes the
    published config's (D, DV), MLA's query/key heads over its value
    heads included, so nothing raises on the card."""
    cfg = get_config(arch)
    dims = (cfg.head_dim_, cfg.head_dim_)
    if cfg.mla is not None:
        dims = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
                cfg.mla.v_head_dim)
    assert dims in FLASH_SHAPES
    pos = torch.arange(2048, dtype=torch.int32)[None].expand(2, -1)
    assert tattn._kernel_gap(cfg, pos, *dims) is None
    if arch == "gemma3-12b":
        assert dims == (D, D)


def test_attention_archs_are_every_registered_one_but_mamba2():
    assert sorted(ATTENTION_ARCHS + ["mamba2-780m"]) == sorted(list_archs())
