"""Port parity: AdamW, its schedules and the global norm, against the
reference's ``repro.optim`` on the CPU.

The reference's three optimizer tests (``tests/test_substrate.py``) run
again on the port. Then ``apply`` runs several steps beside the
reference's on the same seeded parameters and gradients, for each
schedule, with clipping and weight decay on: parameters, both moments, the
step and the metrics within 1e-6 relative of the largest entry (the same
fp32 operations in the same order; ``cos`` and ``pow`` may differ by an
ulp between the frameworks). The update is in place: the parameters and
moments returned are the tensors passed in.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import optim  # noqa: E402


def test_adamw_matches_reference_math():
    cfg = optim.AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8,
                            weight_decay=0.0, grad_clip=0.0,
                            schedule="constant", warmup_steps=0)
    params = {"w": torch.tensor([1.0, 2.0])}
    grads = {"w": torch.tensor([0.5, -0.5])}
    state = optim.init(params)
    new_p, state, _ = optim.apply(cfg, params, grads, state)
    m = 0.1 * 0.5
    v = 0.01 * 0.25
    mhat, vhat = m / 0.1, v / 0.01
    want = 1.0 - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    assert float(new_p["w"][0]) == pytest.approx(want, rel=1e-5)
    assert new_p["w"] is params["w"]                 # updated in place
    assert int(state.step) == 1 and state.step.dtype == torch.int32


def test_grad_clip_limits_update():
    cfg = optim.AdamWConfig(lr=1.0, grad_clip=1e-6, weight_decay=0.0,
                            schedule="constant", warmup_steps=0)
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 1e6)}
    state = optim.init(params)
    _, _, metrics = optim.apply(cfg, params, grads, state)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


def test_schedule_warmup_and_decay():
    cfg = optim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                            schedule="cosine", min_lr_ratio=0.1)
    assert float(optim.learning_rate(cfg, torch.tensor(5))) == \
        pytest.approx(0.5)
    assert float(optim.learning_rate(cfg, torch.tensor(10))) == \
        pytest.approx(1.0)
    assert float(optim.learning_rate(cfg, torch.tensor(110))) == \
        pytest.approx(0.1)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_learning_rate_matches_reference(schedule):
    for warmup in (0, 1, 7):
        cfg = dict(lr=3e-4, warmup_steps=warmup, total_steps=40,
                   schedule=schedule, min_lr_ratio=0.1)
        for step in (0, 1, 3, 7, 8, 20, 39, 40, 41, 100):
            want = float(joptim.learning_rate(joptim.AdamWConfig(**cfg),
                                              jnp.asarray(step, jnp.int32)))
            got = optim.learning_rate(optim.AdamWConfig(**cfg),
                                      torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


def _tree(rng, scale=1.0):
    """A nested tree like a model's: dicts, a list, 1-D and 2-D leaves."""
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": {"embedding": a(16, 8)},
            "stack": {"prefix": [{"w": a(8, 8), "b": a(8)}],
                      "slots": ({"norm": {"scale": a(8)}, "w": a(8, 4)},)},
            "final": a(8)}


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_apply_matches_reference_over_steps(schedule, clip):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=8, schedule=schedule,
               weight_decay=0.1, grad_clip=clip)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = jax.tree.map(lambda x: torch.from_numpy(x.copy()), p0)
    js, ts = joptim.init(jp), optim.init(tp)
    jcfg, tcfg = joptim.AdamWConfig(**cfg), optim.AdamWConfig(**cfg)
    for step in range(6):
        g = _tree(rng, scale=10.0 ** (step % 3 - 1))   # clip on and off
        jp, js, jm = joptim.apply(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = optim.apply(
            tcfg, tp, jax.tree.map(lambda x: torch.from_numpy(x), g), ts)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    assert int(ts.step) == int(js.step) == 6
    for mine, ref in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-6 * np.abs(b).max())


def test_weight_decay_reaches_every_leaf():
    """Norm scales and biases decay too, as in the reference (ROADMAP
    Queue C): with zero gradients each leaf shrinks by lr * wd * p."""
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=0.0,
                            schedule="constant", warmup_steps=0)
    params = {"norm": {"scale": torch.ones(3)}, "bias": torch.full((2,), 2.0)}
    grads = {"norm": {"scale": torch.zeros(3)}, "bias": torch.zeros(2)}
    optim.apply(cfg, params, grads, optim.init(params))
    assert torch.allclose(params["norm"]["scale"], torch.full((3,), 0.95))
    assert torch.allclose(params["bias"], torch.full((2,), 1.9))


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    t = _tree(rng, 3.0)
    want = float(joptim.global_norm(jax.tree.map(jnp.asarray, t)))
    got = optim.global_norm(jax.tree.map(torch.from_numpy, t))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# The fused kernels' host side (kernels/adamw.py); the kernels themselves run
# on the card only (tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

import contextlib  # noqa: E402
import ctypes  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from repro_torch.kernels import adamw, build  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _mixed(rng, grads=False):
    """bf16 and fp32 leaves at odd sizes; as gradients, one bf16 leaf's in
    fp32 (a microbatch sum's)."""
    spec = {"embed": ((9, 16), torch.bfloat16, torch.bfloat16),
            "w": ((16, 12), torch.float32, torch.float32),
            "b": ((7,), torch.float32, torch.float32),
            "experts": ((3, 5, 8), torch.bfloat16, torch.float32)}
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(gd if grads else pd) for k, (s, pd, gd) in spec.items()}


def test_apply_on_cpu_takes_the_plain_body(monkeypatch):
    calls = {"update": 0, "sum": 0}
    update, total = adamw.adamw_update_plain, adamw.sum_squares_plain

    def counted_update(*a, **k):
        calls["update"] += 1
        return update(*a, **k)

    def counted_total(xs):
        calls["sum"] += 1
        return total(xs)
    monkeypatch.setattr(adamw, "adamw_update_plain", counted_update)
    monkeypatch.setattr(adamw, "sum_squares_plain", counted_total)
    rng = np.random.default_rng(3)
    params = _mixed(rng)
    state = optim.init(params)
    before = build.launch_counts()
    for _ in range(2):
        _, state, _ = optim.apply(optim.AdamWConfig(), params,
                                  _mixed(rng, grads=True), state)
    assert build.launch_counts() == before
    assert calls == {"update": 2 * len(params), "sum": 2}


def test_adamw_module_imports_without_nvcc(tmp_path):
    """Importing the wrapper and naming its library builds nothing and
    needs no CUDA toolkit."""
    code = ("import repro_torch.kernels.adamw, repro_torch.optim\n"
            "from repro_torch.kernels import build\n"
            "print(build._SYMBOLS['adamw_update'][0], "
            "build._SYMBOLS['sum_squares'][0], build._target('adamw').name)")
    env = dict(os.environ, PYTHONPATH=SRC, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=str(tmp_path / "no_cuda"),
               REPRO_TORCH_BUILD_DIR=str(tmp_path / "build"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lib, lib2, target = out.stdout.split()
    assert lib == lib2 == "adamw" and target.startswith("libadamw_")
    assert not (tmp_path / "build").exists()


def _leaf(p_dtype=torch.float32, g_dtype=torch.float32, n=24):
    p, g, m, v = (torch.ones(4, n // 4, dtype=d)
                  for d in (p_dtype, g_dtype, torch.float32, torch.float32))
    return p, g, m, v


_SCALARS = tuple(torch.ones(()) for _ in range(4))


@pytest.mark.parametrize("case,error,match", [
    ("fp16", TypeError, "not supported"),
    ("bf16_fp16", TypeError, "not supported"),
    ("fp32_bf16", TypeError, "not supported"),
    ("bf16_m", TypeError, "moments"),
    ("p_strided", ValueError, "p is not contiguous"),
    ("m_strided", ValueError, "m is not contiguous"),
    ("v_strided", ValueError, "v is not contiguous"),
    ("shape", ValueError, "do not match"),
    ("fp64_lr", TypeError, "float32"),
])
def test_update_kernel_refuses_what_it_does_not_take(case, error, match):
    pairs = {"fp16": (torch.float16, torch.float16),
             "bf16_fp16": (torch.bfloat16, torch.float16),
             "fp32_bf16": (torch.float32, torch.bfloat16)}
    p, g, m, v = _leaf(*pairs.get(case, ()))
    scalars = list(_SCALARS)
    if case == "bf16_m":
        m = m.bfloat16()
    elif case.endswith("_strided"):
        t = {"p": p, "m": m, "v": v}[case[0]]
        bad = t.t().contiguous().t()
        p, m, v = (bad if x is t else x for x in (p, m, v))
    elif case == "shape":
        v = v.view(-1)
    elif case == "fp64_lr":
        scalars[1] = scalars[1].double()
    with pytest.raises(error, match=match):
        adamw.check_update(p, g, m, v, *scalars)


@pytest.mark.parametrize("pair", adamw.UPDATE_PAIRS)
def test_update_kernel_takes_its_pairs_and_any_gradient_layout(pair):
    p, g, m, v = _leaf(*pair)
    adamw.check_update(p, g.t(), m, v, *_SCALARS)


def test_sum_squares_blocks():
    assert [adamw.blocks(n) for n in (0, 1, 2048, 2049, 1056 * 2048,
                                      1056 * 2048 + 1, 16 * 6144 * 10752)] \
        == [1, 1, 1, 2, 1056, 1056, 1056]


# The card's kernels emulated over the host memory of CPU tensors, in numpy
# float32 (one rounding an operation, as each __f*_rn is): the wrappers'
# pointers, counts, dtype codes, offsets and constants are what the kernels
# read, and the update's order of operations gives the plain body's bits.

def _at(ptr, n, code):
    ctype = ctypes.c_float if code == 0 else ctypes.c_uint16
    return np.ctypeslib.as_array((ctype * n).from_address(ptr)) if n else \
        np.zeros(0, np.float32 if code == 0 else np.uint16)


def _to_f32(x, code):
    return x if code == 0 else (x.astype(np.uint32) << 16).view(np.float32)


def _store(dst, x, code):
    if code == 0:
        dst[:] = x
    else:                                   # round to nearest, ties to even
        u = x.view(np.uint32)
        dst[:] = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _emulate(calls, name, *args):
    calls.append((name, args))
    f32 = np.float32
    if name == "adamw_update":
        p_, g_, m_, v_, n, pc, gc, s_, lr_, b1c_, b2c_, b1, b2, eps, wd = args
        p, g, m, v = (_at(p_, n, pc), _at(g_, n, gc), _at(m_, n, 0),
                      _at(v_, n, 0))
        scale, lr, b1c, b2c = (_at(x, 1, 0)[0] for x in (s_, lr_, b1c_, b2c_))
        p32, g32 = _to_f32(p, pc), _to_f32(g, gc) * scale
        m[:] = m * f32(b1) + f32(1.0 - b1) * g32
        v[:] = v * f32(b2) + f32(1.0 - b2) * (g32 * g32)
        delta = (m / b1c) / (np.sqrt(v / b2c) + f32(eps))
        if wd != 0.0:
            delta = delta + f32(wd) * p32
        _store(p, p32 - lr * delta, pc)
    else:
        x_, n, code, square, out_, nb = args
        x = _to_f32(_at(x_, n, code), code).astype(np.float64)
        parts = [np.sum(c * c if square else c) for c in
                 np.array_split(x, nb)]
        _at(out_, nb, 0)[:] = np.array(parts, np.float32)


@pytest.mark.parametrize("gnorm", [False, True])
def test_card_route_hands_the_kernels_what_they_read(monkeypatch, gnorm):
    """``apply`` through the card's route (its kernels emulated): one
    update launch a leaf and one sum-of-squares launch a leaf plus one for
    the tree, each with its leaf's pointers, size and dtypes, the partial
    sums laid end to end; the state the plain body's, bit for bit."""
    calls = []
    monkeypatch.setattr(adamw, "plain_device", lambda t: False)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(adamw, "stream_of", lambda d: 0)
    monkeypatch.setattr(adamw, "launch",
                        lambda name, *a: _emulate(calls, name, *a[:-1]))
    rng = np.random.default_rng(5)
    cfg = optim.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=0.5,
                            warmup_steps=2, total_steps=10)
    mine = _mixed(rng)
    plain = {k: v.clone() for k, v in mine.items()}
    s_mine, s_plain = optim.init(mine), optim.init(plain)
    sizes = [p.numel() for p in leaves(mine)]
    for _ in range(3):
        g = _mixed(rng, grads=True)
        norm = optim.global_norm(g) if gnorm else None
        del calls[:]
        _, s_mine, m_mine = optim.apply(cfg, mine, g, s_mine, gnorm=norm)
        with monkeypatch.context() as mp:
            mp.setattr(adamw, "plain_device", lambda t: True)
            _, s_plain, m_plain = optim.apply(cfg, plain, g, s_plain,
                                              gnorm=norm)
        names = [c[0] for c in calls]
        sums = [] if gnorm else calls[:len(sizes) + 1]
        assert names == ["sum_squares"] * len(sums) + \
            ["adamw_update"] * len(sizes)
        if sums:
            at = sums[0][1][4]
            for (_, (_, n, code, square, out, nb)), x in zip(sums, leaves(g)):
                assert (n, code, square, out, nb) == (
                    x.numel(), 0 if x.dtype == torch.float32 else 1, 1, at,
                    adamw.blocks(x.numel()))
                at += 4 * nb
            assert sums[-1][1][1:4] == (len(sizes), 0, 0)
        assert float(m_mine["grad_norm"]) == pytest.approx(
            float(m_plain["grad_norm"]), rel=1e-6)
        for (_, args), p in zip(calls[len(sums):], leaves(mine)):
            assert args[4] == p.numel() and args[11:] == (
                cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
        if gnorm:
            for a, b in ((mine, plain), (s_mine.m, s_plain.m),
                         (s_mine.v, s_plain.v)):
                for k in a:
                    assert torch.equal(a[k], b[k]), k
