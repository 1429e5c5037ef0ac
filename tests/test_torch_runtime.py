"""Port parity for the slice as a whole: runtime and paged KV cache.

The same chains go through the JAX package's ``DMARuntime`` and the
port's ``DMARuntime(device="cpu")``. Pools, ring state, tickets,
completion records, ``translation_stats()`` and ``stats()`` (minus the
wall-clock fields) must be identical. ``PagedKVCache`` is loaded into the
port from the JAX cache's exported state (``from_numpy_state``), and
``move_pages`` and ``defragment`` in both modes must leave identical
caches. kv_int8 pools must be within one quantisation step of JAX's and
exact against the reference's numpy oracle (see
``tests/test_torch_descriptor.py`` for why not against XLA).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.runtime as jrt  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
from repro.core import chain as jchain  # noqa: E402
from repro.core.pageref import PageRef as JPageRef  # noqa: E402
from repro.core.transform import as_transform, reference_apply  # noqa: E402
from repro.serve.kv_cache import PagedKVCache as JCache  # noqa: E402
from repro_torch.core import chain as tchain  # noqa: E402
from repro_torch.core.pageref import PageRef as TPageRef  # noqa: E402
from repro_torch.serve.kv_cache import PagedKVCache as TCache  # noqa: E402

WALL_CLOCK = ("drain_seconds", "launch_us_per_descriptor")


def _strip(stats):
    out = {k: v for k, v in stats.items() if k not in WALL_CLOCK}
    out["channels"] = {n: {k: v for k, v in c.items() if k not in WALL_CLOCK}
                       for n, c in stats["channels"].items()}
    out["translation_cache"] = dict(stats["translation_cache"])
    return out


def _records(recs):
    return [dataclasses.astuple(r) for r in recs]


def _assert_same_runtime(jr, tr):
    assert set(jr.pools) == set(tr.pools)
    for name in jr.pools:
        np.testing.assert_array_equal(tr.pools[name].numpy(),
                                      np.asarray(jr.pools[name]), name)
    for name, jc in jr.channels.items():
        tc = tr.channels[name]
        assert (tc.ring.head, tc.ring.tail) == (jc.ring.head, jc.ring.tail)
        assert tc.ring.table.tobytes() == jc.ring.table.tobytes()
        np.testing.assert_array_equal(tc.ring._tickets, jc.ring._tickets)
        assert tc.ring.live_done_tickets() == jc.ring.live_done_tickets()
    assert tr._next_ticket == jr._next_ticket
    assert _records(tr.poll()) == _records(jr.poll())
    assert dict(tr.translation_stats()) == dict(jr.translation_stats())
    assert _strip(tr.stats()) == _strip(jr.stats())


def _both_runtimes(make):
    return make(jrt, {}), make(trt, {"device": "cpu"})


def _register(jr, tr, name, arr):
    jr.register_pool(name, jnp.asarray(arr))
    tr.register_pool(name, torch.from_numpy(arr.copy()))


def _submit_both(jr, tr, chains, **kw):
    (jd, td) = chains
    jt = jr.submit(jrt.SubmitRequest(chain=jd, **kw))
    tt = tr.submit(trt.SubmitRequest(chain=td, **kw))
    assert (tt.tickets, tt.channel, tt.spilled, tt.transform) == \
        (jt.tickets, jt.channel, jt.spilled, jt.transform)
    return jt, tt


def _moves(src, dst):
    n = len(src)
    args = (np.asarray(src, np.int64), np.asarray(dst, np.int64),
            np.ones(n, np.int64))
    return (jchain.from_segments(*args), tchain.from_segments(*args))


# ---------------------------------------------------------------------------
# Multi-channel fused blocked_2d drains (with RAW/WAW splits)
# ---------------------------------------------------------------------------

def test_fused_multichannel_2d_drains_identical():
    jr, tr = _both_runtimes(
        lambda m, kw: m.default_runtime(4, tier="blocked_2d",
                                        ring_capacity=8, **kw))
    rng = np.random.default_rng(0)
    a = rng.standard_normal((24, 4, 8)).astype(np.float32)
    b = rng.standard_normal((24, 4, 8)).astype(np.float32)
    _register(jr, tr, "a", a)
    _register(jr, tr, "b", b)
    batches = [([0, 1, 2], [10, 11, 12], "a", "b"),
               ([3, 4], [13, 14], "a", "b"),
               ([10, 5], [20, 21], "b", "b"),      # reads rows written above
               ([6, 7], [10, 22], "a", "b"),       # rewrites row 10 (WAW)
               ([1, 2, 3], [5, 6, 7], "a", "a")]   # in-pool move
    for s, d, sp, dp in batches:
        _submit_both(jr, tr, _moves(s, d), src_pool=sp, dst_pool=dp)
    jr.drain_until_idle()
    tr.drain_until_idle()
    _assert_same_runtime(jr, tr)


def test_use_kernel_channel_and_backpressure_identical():
    def make(m, kw):
        return m.DMARuntime(
            [m.ChannelConfig(name="k", tier="blocked_2d", use_kernel=True,
                             ring_capacity=4),
             m.ChannelConfig(name="s", tier="blocked_2d", ring_capacity=4)],
            **kw)
    jr, tr = _both_runtimes(make)
    rng = np.random.default_rng(1)
    _register(jr, tr, "p", rng.standard_normal((16, 32)).astype(np.float32))
    _register(jr, tr, "q", rng.standard_normal((16, 32)).astype(np.float32))
    for i in range(3):
        # 6-descriptor chains on 4-slot rings: split into ring-sized pieces
        # and drained under "block" backpressure through the legacy engine.
        s = list(range(i, i + 6))
        d = [(x * 5 + i) % 16 for x in range(6)]
        _submit_both(jr, tr, _moves(s, d), src_pool="p", dst_pool="q",
                     channel="k" if i % 2 == 0 else "s")
    jr.drain_until_idle()
    tr.drain_until_idle()
    _assert_same_runtime(jr, tr)


# ---------------------------------------------------------------------------
# Serial chains: lowered vector / serial routes, kv_int8, reduce_sum, spill
# ---------------------------------------------------------------------------

def _serial_runtime(m, kw, **extra):
    return m.DMARuntime(
        [m.ChannelConfig(name="s0", tier="serial", ring_capacity=16,
                         max_len=256),
         m.ChannelConfig(name="s1", tier="serial", ring_capacity=16,
                         max_len=256)], **extra, **kw)


@pytest.mark.parametrize("transform", ["identity", "reduce_sum"])
def test_serial_chains_identical(transform):
    jr, tr = _both_runtimes(_serial_runtime)
    rng = np.random.default_rng(2)
    _register(jr, tr, "src", rng.standard_normal(2048).astype(np.float32))
    _register(jr, tr, "dst", rng.standard_normal(2048).astype(np.float32))
    chains = [  # aligned pages, an overlapping chain, a mergeable run
        ([0, 512, 256], [1024, 1280, 1536], [256] * 3),
        ([0, 10, 20], [100, 105, 90], [30, 30, 30]),
        ([0, 64, 128, 192], [700, 764, 828, 892], [64] * 4),
        ([1900, 40], [1990, 0], [100, 50]),        # near the tail: declines
    ]
    for s, d, ln in chains:
        args = [np.asarray(x, np.int64) for x in (s, d, ln)]
        _submit_both(jr, tr, (jchain.from_segments(*args),
                              tchain.from_segments(*args)),
                     src_pool="src", dst_pool="dst", transform=transform)
    jr.drain_until_idle()
    tr.drain_until_idle()
    _assert_same_runtime(jr, tr)


def test_kv_int8_serial_chain_matches_within_one_step():
    jr, tr = _both_runtimes(_serial_runtime)
    rng = np.random.default_rng(3)
    src = (rng.standard_normal(2048) * 2).astype(np.float32)
    dst = rng.standard_normal(2048).astype(np.float32)
    _register(jr, tr, "src", src)
    _register(jr, tr, "dst", dst)
    args = [np.asarray(x, np.int64) for x in
            ([1536, 0, 768], [256, 1024, 0], [256, 256, 256])]
    jd, td = jchain.from_segments(*args), tchain.from_segments(*args)
    _submit_both(jr, tr, (jd, td), src_pool="src", dst_pool="dst",
                 transform="kv_int8")
    jr.drain_until_idle()
    tr.drain_until_idle()
    got = tr.pools["dst"].numpy()
    want = np.asarray(jr.pools["dst"])
    step = float(np.abs(src).max()) / 127.0
    assert float(np.max(np.abs(got - want))) <= step   # stated tolerance
    oracle = reference_apply(as_transform("kv_int8"), jd, src, dst)
    np.testing.assert_array_equal(got, oracle)          # exact
    # Everything but the float payload is identical.
    tr.pools["dst"] = torch.from_numpy(want.copy())
    _assert_same_runtime(jr, tr)


def test_spill_backpressure_identical():
    jr, tr = _both_runtimes(
        lambda m, kw: _serial_runtime(m, kw, backpressure="spill"))
    rng = np.random.default_rng(4)
    _register(jr, tr, "src", rng.standard_normal(4096).astype(np.float32))
    _register(jr, tr, "dst", np.zeros(4096, np.float32))
    for k in range(5):
        n = 10
        s = np.arange(n, dtype=np.int64) * 64 + k * 700
        d = s[::-1] + 3
        args = (s, d, np.full(n, 32, np.int64))
        _submit_both(jr, tr, (jchain.from_segments(*args),
                              tchain.from_segments(*args)),
                     src_pool="src", dst_pool="dst", channel="s0")
    jr.drain_until_idle()
    tr.drain_until_idle()
    _assert_same_runtime(jr, tr)


# ---------------------------------------------------------------------------
# Paged KV cache: state carry-over, move_pages, defragment (both modes)
# ---------------------------------------------------------------------------

def _jax_cache(seed=0):
    cache = JCache(page=4, num_pages=24, max_seqs=3, max_pages_per_seq=8,
                   kv_heads=2, head_dim=8)
    rng = np.random.default_rng(seed)
    for s in range(3):
        cache.admit(s)
    for step in range(11):                     # interleaved growth
        for s in range(3):
            if s == 2 and step > 6:
                continue
            cache.append(s, rng.standard_normal((2, 8)).astype(np.float32),
                         rng.standard_normal((2, 8)).astype(np.float32))
    cache.evict(1)                             # free an interleaved run
    return cache


def _export(c):
    snap = c.page_table.snapshot()
    return {"k_pages": np.asarray(c.k_pages), "v_pages": np.asarray(c.v_pages),
            "tables": c.tables, "lengths": c.lengths,
            "slot": snap["slot"], "gen": snap["gen"],
            "generation": c.page_table.generation,
            "remaps": c.page_table.remaps,
            "free": list(c.alloc._free),
            "owned": {s: list(p) for s, p in c.alloc._owned.items()}}


def _assert_same_cache(jc, tc):
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tc.v_pages.numpy(), np.asarray(jc.v_pages))
    np.testing.assert_array_equal(tc.tables, jc.tables)
    np.testing.assert_array_equal(tc.lengths, jc.lengths)
    for k, v in jc.page_table.snapshot().items():
        np.testing.assert_array_equal(tc.page_table.snapshot()[k], v, k)
    assert tc.alloc._free == jc.alloc._free
    assert tc.alloc._owned == jc.alloc._owned
    assert tc._phys_free == jc._phys_free
    for s in range(jc.max_seqs):
        for a, b in zip(tc.dense_view(s), jc.dense_view(s)):
            np.testing.assert_array_equal(a, b)
    jk = jc.kernel_args()
    for a, b in zip(tc.kernel_args(), jk):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_from_numpy_state_reproduces_the_cache():
    jc = _jax_cache()
    tc = TCache.from_numpy_state(_export(jc), device="cpu")
    _assert_same_cache(jc, tc)
    back = TCache.from_numpy_state(tc.to_numpy_state(), device="cpu")
    _assert_same_cache(jc, back)


def test_move_pages_identical():
    jc = _jax_cache(1)
    tc = TCache.from_numpy_state(_export(jc), device="cpu")
    jr = jrt.default_runtime(4, tier="blocked_2d", ring_capacity=16)
    tr = trt.default_runtime(4, tier="blocked_2d", ring_capacity=16,
                             device="cpu")
    src = [int(p) for p in jc.tables[0] if p >= 0][:3]
    dst = sorted(jc.alloc._free)[:3]
    jc.move_pages(jr, [JPageRef(p) for p in src], [JPageRef(p) for p in dst])
    tc.move_pages(tr, [TPageRef(p) for p in src], [TPageRef(p) for p in dst])
    _assert_same_cache(jc, tc)
    _assert_same_runtime(jr, tr)


@pytest.mark.parametrize("mode", ["copy", "remap"])
def test_defragment_identical(mode):
    jc = _jax_cache(2)
    tc = TCache.from_numpy_state(_export(jc), device="cpu")
    jr = jrt.default_runtime(2, ring_capacity=16)
    tr = trt.default_runtime(2, ring_capacity=16, device="cpu")
    for slot in (0, 2):
        jrate = jc.defragment(slot, jr, mode=mode)
        trate = tc.defragment(slot, tr, mode=mode)
        assert trate == jrate
    _assert_same_cache(jc, tc)
    _assert_same_runtime(jr, tr)


# ---------------------------------------------------------------------------
# Devices and imports
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda_and_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        trt.default_runtime(2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        trt.DMARuntime([trt.ChannelConfig(name="c")])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TCache(page=4, num_pages=4, max_seqs=1, max_pages_per_seq=4,
               kv_heads=1, head_dim=8)


def test_pools_must_lie_on_the_runtime_device_and_not_alias():
    rt = trt.default_runtime(1, device="cpu")
    with pytest.raises(ValueError, match="lies on meta"):
        rt.register_pool("m", torch.empty(4, device="meta"))
    x = torch.zeros(8)
    rt.register_pool("a", x)
    rt.register_pool("a", x)                      # refreshing one name is fine
    with pytest.raises(ValueError, match="shares storage"):
        rt.register_pool("b", x.view(2, 4))
    rt.register_numpy_pools({"c": np.ones(3, np.float32)})
    assert rt.numpy_pools()["c"].tolist() == [1.0, 1.0, 1.0]


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.runtime, "
            "repro_torch.serve.kv_cache, repro_torch.kernels, "
            "repro_torch.kernels.ops, repro_torch.mmu, repro_torch.obs, "
            "repro_torch.optim\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(','.join(bad))\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env={"PYTHONPATH": str(root / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
    smoke = (root / "chip_smoke.py").read_text()
    assert "import jax" not in smoke and "from repro." not in smoke \
        and "import repro\n" not in smoke
