"""The gradient of flash attention on the CPU: the port's explicit
backward against autograd and against the reference.

``flash_attention_backward_plain`` (the math the CUDA backward kernel
computes: P rebuilt from the forward's log-sum-exp, D = rowsum(P * dP),
dS = P * (dO V^T - D)) is held against ``torch.autograd`` of
``flash_attention_plain`` and against ``jax.vjp`` of the reference's
``blockwise_attention`` (``repro/models/attention.py``), on seeded numpy
inputs in fp32: causal, windowed and not causal, GQA (an odd group
too), Sq != Sk both ways, and (D, DV) of (64, 64), (96, 96), (128, 128)
and MLA's (192, 128) (G 1 causal, not causal, windowed and at Sq < Sk).
Each of dQ, dK and dV
within 1e-5 of its largest reference entry (fp32 sums in other orders).
``flash_attention`` under autograd on the CPU (``FlashAttentionFn``) is
held against both the same way, and without grad it runs no backward and
keeps no log-sum-exp. In bf16, over keys and values that share a large
mean (a cross-attention over near-identical memory rows), dQ is a small
difference that D from the rounded output would swamp: the plain
backward holds it at cosine 0.9999 to fp64, at head dims 64 and MLA's
(192, 128). ``bwd_design`` names the backward kernel's design (tensor
or CUDA cores) for every shape and dtype, as PERF.md's table says.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import blockwise_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FLASH_SHAPES,
    FlashAttentionFn,
    bwd_design,
    flash_attention,
    flash_attention_backward_plain,
    flash_attention_plain,
)

TOL = 1e-5

#: B, S, H, KV, D, DV, causal, window.
CASES = [
    (2, 48, 8, 2, 64, 64, True, None),        # GQA 4
    (1, 40, 4, 4, 64, 64, True, 8),           # windowed
    (2, 32, 4, 2, 64, 64, False, None),       # not causal
    (1, 30, 6, 3, 96, 96, True, None),
    (1, 36, 4, 1, 128, 128, True, 16),        # GQA 4, windowed
    (2, 24, 4, 4, 192, 128, True, None),      # MLA's heads
    (1, 20, 4, 2, 128, 128, False, 6),        # windowed, not causal
    (1, 28, 6, 2, 64, 64, True, None),        # GQA 3: an odd group
    (2, (24, 40), 4, 2, 64, 64, True, None),  # Sq < Sk: keys no query sees
    (1, (40, 24), 4, 2, 128, 128, True, None),  # Sq > Sk
    (1, (20, 36), 4, 4, 192, 128, True, None),  # MLA, G 1: Sq < Sk
    (2, 28, 4, 4, 192, 128, False, None),       # MLA, not causal
    (1, 40, 4, 4, 192, 128, True, 8),           # MLA, windowed
    (1, 36, 4, 4, 96, 96, True, 8),             # 96, windowed
    (1, (20, 36), 8, 2, 96, 96, True, None),    # 96, G 4: Sq < Sk
    (1, (36, 20), 4, 4, 96, 96, False, 24),     # 96: Sq > Sk, windowed
]


def _lengths(s):
    """(Sq, Sk) of a case's S: one length, or the two."""
    return s if isinstance(s, tuple) else (s, s)


def _inputs(b, s, h, kv, d, dv, seed):
    sq, sk = _lengths(s)
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    return f(b, sq, h, d), f(b, sk, kv, d), f(b, sk, kv, dv), f(b, sq, h, dv)


def _reference_vjp(q, k, v, do, causal, window):
    _, vjp = jax.vjp(lambda q, k, v: blockwise_attention(
        q, k, v, causal=causal, window=window, q_block=q.shape[1],
        kv_block=k.shape[1]), *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _autograd(q, k, v, do, causal, window, fn):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, causal=causal, window=window)
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(do))


def _close(got, want, what):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
        assert a.shape == b.shape, (what, name)
        err = float(np.abs(a - b).max())
        assert err <= TOL * float(np.abs(b).max()), (what, name, err)


@pytest.mark.parametrize("b,s,h,kv,d,dv,causal,window", CASES)
def test_backward_plain_matches_autograd_and_reference(b, s, h, kv, d, dv,
                                                       causal, window):
    q, k, v, do = _inputs(b, s, h, kv, d, dv, sum(_lengths(s)) + d)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window, return_lse=True)
    assert lse.shape == (b, h, _lengths(s)[0]) \
        and lse.dtype == torch.float32
    got = flash_attention_backward_plain(tq, tk, tv, out, lse, tdo,
                                         causal=causal, window=window)
    _, auto = _autograd(q, k, v, do, causal, window, flash_attention_plain)
    _close(got, auto, "autograd of the plain forward")
    _close(got, _reference_vjp(q, k, v, do, causal, window),
           "jax.vjp of blockwise_attention")


@pytest.mark.parametrize("b,s,h,kv,d,dv,causal,window", CASES[::2])
def test_autograd_function_on_cpu_matches_both(b, s, h, kv, d, dv, causal,
                                               window):
    q, k, v, do = _inputs(b, s, h, kv, d, dv, 7 * _lengths(s)[0])
    out, got = _autograd(q, k, v, do, causal, window, flash_attention)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    _, auto = _autograd(q, k, v, do, causal, window, flash_attention_plain)
    _close(got, auto, "autograd of the plain forward")
    _close(got, _reference_vjp(q, k, v, do, causal, window), "jax.vjp")


def test_lse_is_the_rows_log_sum_exp():
    q, k, v, _ = _inputs(1, 16, 4, 2, 64, 64, 1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _, lse = flash_attention_plain(tq, tk, tv, causal=True, window=5,
                                   return_lse=True)
    s = torch.einsum("qhd,khd->hqk", tq[0],
                     tk[0].repeat_interleave(2, dim=1)) * 64 ** -0.5
    i, j = torch.arange(16)[:, None], torch.arange(16)[None]
    s = s.masked_fill(~((j <= i) & (i - j < 5)), float("-inf"))
    torch.testing.assert_close(lse[0], torch.logsumexp(s, -1), rtol=1e-6,
                               atol=1e-6)


def test_rows_without_keys_get_zero_gradients():
    """More queries than keys under a window: rows that see no key give
    zero output and zero gradients, and add nothing to dK and dV."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 10, 2, 64), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 6, 1, 64), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 6, 1, 64), np.float32))
    do = torch.from_numpy(rng.standard_normal((1, 10, 2, 64), np.float32))
    out, lse = flash_attention_plain(q, k, v, causal=True, window=2,
                                     return_lse=True)
    dq, dk, dv = flash_attention_backward_plain(q, k, v, out, lse, do,
                                                causal=True, window=2)
    assert not out[0, 7:].any() and not dq[0, 7:].any()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(flash_attention_plain(*leaves, causal=True,
                                                     window=2), leaves, do)
    _close((dq, dk, dv), auto, "autograd")


def test_no_grad_forward_keeps_nothing():
    q = torch.randn((1, 8, 2, 64), requires_grad=True)
    with torch.no_grad():
        out = flash_attention(q, q.detach(), q.detach())
    assert out.grad_fn is None
    out = flash_attention(q.detach(), q.detach(), q.detach())
    assert out.grad_fn is None and not out.requires_grad
    assert issubclass(FlashAttentionFn, torch.autograd.Function)


#: The backward kernel's design by (D, DV) and dtype, as PERF.md states it:
#: bf16 on the tensor cores at every pair (the reduced configs' narrow
#: heads in one zero-filled box, MLA's (192, 128) and gemma3-12b's
#: (256, 256) through dK/dV kernels of their own), fp32 (exact sums) on the
#: CUDA cores.
DESIGNS = {(16, 16): "tensor_core", (24, 24): "tensor_core",
           (24, 16): "tensor_core", (32, 32): "tensor_core",
           (64, 64): "tensor_core", (96, 96): "tensor_core",
           (128, 128): "tensor_core", (192, 128): "tensor_core",
           (256, 256): "tensor_core"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv", FLASH_SHAPES)
def test_bwd_design_follows_the_table(d, dv, dtype):
    want = DESIGNS[(d, dv)] if dtype == torch.bfloat16 else "cuda_core"
    assert bwd_design(d, dv, dtype) == want


def _common_mean(seed, b=2, s=96, h=4, d=64, dv=64):
    """bf16 q, dO and k, v whose rows share 99.9 % of their norm."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    mean_k, mean_v = f(1, 1, h, d) * 3, f(1, 1, h, dv) * 3
    k = mean_k + 0.05 * f(b, s, h, d)
    v = mean_v + 0.05 * f(b, s, h, dv)
    return [torch.from_numpy(x).to(torch.bfloat16)
            for x in (f(b, s, h, d), k, v, f(b, s, h, dv))]


def _fp64_grads(q, k, v, do, causal):
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    sc = torch.einsum("bqhd,bkhd->bhqk", leaves[0], leaves[1]) \
        * q.shape[-1] ** -0.5
    if causal:
        sq, sk = sc.shape[-2:]
        sc = sc.masked_fill(~torch.ones(sq, sk, dtype=torch.bool).tril(),
                            float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), leaves[2])
    return torch.autograd.grad(out, leaves, do.double())


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("causal", [False, True])
def test_backward_plain_is_exact_over_keys_with_a_common_mean(causal):
    q, k, v, do = _common_mean(7)
    out, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_backward_plain(q, k, v, out, lse, do,
                                         causal=causal)
    want = _fp64_grads(q, k, v, do, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _cos(a, b) >= 0.9999, (name, _cos(a, b))


@pytest.mark.parametrize("causal", [False, True])
def test_backward_plain_is_exact_over_mla_keys_with_a_common_mean(causal):
    """The same at MLA's heads of 192 over values of 128, the Delta the
    tensor-core kernel at (192, 128) is held to."""
    q, k, v, do = _common_mean(11, d=192, dv=128)
    out, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_backward_plain(q, k, v, out, lse, do,
                                         causal=causal)
    want = _fp64_grads(q, k, v, do, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        assert _cos(a, b) >= 0.9999, (name, _cos(a, b))
