"""Port parity: the sharded DMA runtime, its KV pool and sharded serving.

The port's ``distributed`` package against the reference's on the same
seeded contents and the same page moves: pools bit for bit, migration
stats, fabric counters, page tables and free lists exactly, for
``move_pages`` under both fabrics at 1, 2, 4 and 8 shards, ``defragment``
in copy and remap modes, ownership flips with first-touch pulls and
``evacuate``/``readmit``; the shardlib lifecycle; the storage isolation the
port needs because its drains write pools in place; and the
``ShardedServeEngine`` on reduced qwen2.5-3b with the reference's weights
(``params_from_jax``, fp32 compute): routing, remote page reads,
completion order, greedy tokens and ``perf_counters()``. Everything runs
on the CPU.
"""
import dataclasses
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed.sharded_runtime import (  # noqa: E402
    ShardedDMARuntime as JSRT,
    ShardedKVPool as JKV,
    ShardedServeEngine as JSharded,
)
from repro.models import init_params as jinit  # noqa: E402
from repro.obs.record import record_serve_trace as jrecord  # noqa: E402
from repro.runtime import SubmitRequest as JSubmitRequest  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.chain import from_segments  # noqa: E402
from repro_torch.distributed import shardlib  # noqa: E402
from repro_torch.distributed.sharded_runtime import (  # noqa: E402
    MigrationStats,
    PageOwnerMap,
    ShardedDMARuntime,
    ShardedKVPool,
    ShardedServeEngine,
    resolve_num_shards,
)
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.obs.record import record_serve_trace  # noqa: E402
from repro_torch.perf.sharded_cell import (  # noqa: E402
    DEFAULT_SHARDED_SPEC,
    _mesh_for,
    _zipf_moves,
)
from repro_torch.runtime import (  # noqa: E402
    ChannelConfig,
    DMARuntime,
    SubmitRequest,
    Ticket,
)
from repro_torch.serve import Request  # noqa: E402

STAGE = ShardedDMARuntime.STAGE_POOL


# ---------------------------------------------------------------------------
# shardlib mesh/rules lifecycle
# ---------------------------------------------------------------------------

class _FakeMesh:
    shape = {"data": 2, "model": 2}


class _BigFakeMesh:
    shape = {"data": 4, "model": 2}


def test_set_mesh_none_clears_rules_like_clear_mesh():
    shardlib.set_mesh(_FakeMesh())
    shardlib.set_rules({"batch": "data", "heads": "model"})
    assert shardlib.current_rules()
    shardlib.set_mesh(None)
    assert shardlib.current_mesh() is None
    assert shardlib.current_rules() == {}
    shardlib.set_mesh(_FakeMesh())
    shardlib.set_rules({"batch": "data"})
    shardlib.clear_mesh()
    assert shardlib.current_mesh() is None
    assert shardlib.current_rules() == {}


def test_use_mesh_restores_state_when_body_resizes_mesh_and_raises():
    shardlib.set_mesh(_FakeMesh())
    shardlib.set_rules({"batch": "data"})
    with pytest.raises(RuntimeError):
        with shardlib.use_mesh(_FakeMesh(), {"batch": "data"}):
            shardlib.set_mesh(_BigFakeMesh())
            shardlib.set_rules({"batch": "data", "heads": "model"})
            raise RuntimeError("resize failed mid-launch")
    assert isinstance(shardlib.current_mesh(), _FakeMesh)
    assert shardlib.current_rules() == {"batch": "data"}
    with pytest.raises(RuntimeError):
        with shardlib.use_mesh(_BigFakeMesh()):
            shardlib.clear_mesh()
            raise RuntimeError("boom")
    assert isinstance(shardlib.current_mesh(), _FakeMesh)
    assert shardlib.current_rules() == {"batch": "data"}
    shardlib.clear_mesh()


def test_use_mesh_restores_state_when_install_itself_throws():
    shardlib.set_mesh(_FakeMesh())
    shardlib.set_rules({"batch": "data"})
    with pytest.raises(TypeError):
        with shardlib.use_mesh(_BigFakeMesh(), rules=42):
            pass   # pragma: no cover - the install raises first
    assert isinstance(shardlib.current_mesh(), _FakeMesh)
    assert shardlib.current_rules() == {"batch": "data"}
    shardlib.clear_mesh()


def test_use_mesh_restores_previous_state_even_on_error():
    shardlib.set_mesh(None)
    with shardlib.use_mesh(_FakeMesh(), {"batch": "data"}):
        assert shardlib.current_rules() == {"batch": "data"}
        assert shardlib.axis_size("data") == 2
        assert shardlib.axis_size("nope") == 1
        assert shardlib.logical_spec("batch", None, "heads") == \
            ("data", None, None)
    assert shardlib.current_mesh() is None and shardlib.axis_size("data") == 1
    with pytest.raises(RuntimeError):
        with shardlib.use_mesh(_FakeMesh(), {"batch": "data"}):
            raise RuntimeError("boom")
    assert shardlib.current_mesh() is None
    assert shardlib.current_rules() == {}


def test_mesh_state_is_thread_local():
    shardlib.set_mesh(_FakeMesh())
    shardlib.set_rules({"batch": "data"})
    seen = {}

    def worker():
        seen["mesh"] = shardlib.current_mesh()
        seen["rules"] = shardlib.current_rules()
        shardlib.set_mesh(_FakeMesh())
        shardlib.set_rules({"batch": "model"})

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert seen == {"mesh": None, "rules": {}}
    assert shardlib.current_rules() == {"batch": "data"}
    shardlib.clear_mesh()


def test_shard_is_the_identity_and_checks_rank_under_a_mesh():
    x = torch.ones(2, 3)
    assert shardlib.shard(x, "batch") is x            # no mesh: no check
    with shardlib.use_mesh(shardlib.Mesh(["cpu", "cpu"], ("dma",)),
                           {"batch": "dma"}):
        assert shardlib.shard(x, "batch", None) is x
        with pytest.raises(ValueError, match="rank-2"):
            shardlib.shard(x, "batch")
    m = shardlib.Mesh([["cpu", "cpu"]], ("a", "b"))
    assert dict(m.shape) == {"a": 1, "b": 2}
    assert list(m.devices.flat) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="axis names"):
        shardlib.Mesh(["cpu"], ("a", "b"))


# ---------------------------------------------------------------------------
# Page ownership, shard counts, meshes
# ---------------------------------------------------------------------------

def test_page_owner_map_partition_and_validation():
    m = PageOwnerMap(num_pages=32, num_shards=4)
    assert m.pages_per_shard == 8
    assert [m.owner(p) for p in (0, 7, 8, 31)] == [0, 0, 1, 3]
    assert m.local_row(17) == 1
    assert list(m.shard_pages(2)) == list(range(16, 24))
    with pytest.raises(IndexError):
        m.owner(32)
    with pytest.raises(ValueError, match="partition evenly"):
        PageOwnerMap(num_pages=10, num_shards=4)
    with pytest.raises(ValueError, match=">= 1 shard"):
        PageOwnerMap(num_pages=4, num_shards=0)


def test_resolve_num_shards_is_shape_agnostic():
    class M1:
        shape = {"a": 1, "b": 4}

    class M2:
        shape = {"a": 4, "b": 1}
    assert resolve_num_shards(M1()) == resolve_num_shards(M2()) == 4
    assert resolve_num_shards(None) == 1


def test_mesh_shape_equivalence_1xN_vs_Nx1():
    """Meshes of CPU devices: a 1x4 and a 4x1 mesh are the same sharded
    runtime, and both equal the unmeshed reference."""
    content = np.random.default_rng(3).standard_normal(
        (32, 8)).astype(np.float32)
    src, dst = [25, 26, 27, 9, 2], [0, 1, 3, 30, 17]
    outs = []
    for shape in ((1, 4), (4, 1)):
        mesh = shardlib.Mesh(np.full(shape, "cpu", dtype=object), ("a", "b"))
        srt = ShardedDMARuntime(mesh=mesh)
        assert srt.num_shards == 4
        assert {rt.device.type for rt in srt.shards} == {"cpu"}
        kv = ShardedKVPool(srt, num_pages=32, page=8, kv_heads=1,
                           head_dim=1)
        _fill(srt, kv, content, torch.from_numpy)
        stats = kv.move_pages(kv.refs(src), kv.refs(dst))
        outs.append((srt.gather_pool(kv.POOL_K),
                     dataclasses.asdict(stats)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    j = JSRT(num_shards=4)
    jk = JKV(j, num_pages=32, page=8, kv_heads=1, head_dim=1)
    _fill(j, jk, content, jnp.asarray)
    jstats = jk.move_pages(jk.refs(src), jk.refs(dst))
    np.testing.assert_array_equal(outs[0][0], j.gather_pool(jk.POOL_K))
    assert outs[0][1] == dataclasses.asdict(jstats)


def test_mesh_shard_count_mismatch_and_ambient_meshes():
    mesh = shardlib.Mesh(["cpu", "cpu"], ("a",))
    with pytest.raises(ValueError, match="mesh has 2"):
        ShardedDMARuntime(num_shards=4, mesh=mesh)
    # An ambient mesh of the wrong size does not veto an explicit count.
    with shardlib.use_mesh(_FakeMesh()):
        srt = ShardedDMARuntime(num_shards=1, device="cpu")
        assert srt.num_shards == 1 and srt.mesh is None
        kv = ShardedKVPool(srt, num_pages=8, page=4, kv_heads=1,
                           head_dim=1)
        kv.write_page(kv.refs([0])[0], np.ones(4), np.ones(4))
        kv.move_pages(kv.refs([0]), kv.refs([5]))
        np.testing.assert_array_equal(kv.page_rows(kv.refs([5]))[0][0],
                                      np.ones(4))
    # An ambient mesh of the right size places the shards on its devices.
    with shardlib.use_mesh(mesh):
        srt = ShardedDMARuntime()
        assert srt.num_shards == 2 and srt.mesh is mesh
    # The cells' mesh: never on the CPU, never past the visible cards.
    assert _mesh_for(4, "cpu") is None and _mesh_for(1, "cpu") is None


def test_sharded_runtime_runs_on_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ShardedDMARuntime(num_shards=2)
    srt = ShardedDMARuntime(num_shards=2, device="cpu")
    assert {rt.device for rt in srt.shards} == {torch.device("cpu")}


# ---------------------------------------------------------------------------
# Both packages on one seeded content
# ---------------------------------------------------------------------------

def _fill(srt, kv, content, conv):
    flat = content.reshape(-1)
    srt.register_sharded_pool(kv.POOL_K, conv(flat.copy()), kv.owner,
                              kv.row_elems)
    srt.register_sharded_pool(kv.POOL_V, conv(-flat), kv.owner,
                              kv.row_elems)


def _pair(num_shards, pages_per_shard, row, seed, **kw):
    num_pages = pages_per_shard * num_shards
    content = np.random.default_rng(seed).standard_normal(
        (num_pages, row)).astype(np.float32)
    j = JSRT(num_shards=num_shards, **kw)
    jk = JKV(j, num_pages=num_pages, page=row, kv_heads=1, head_dim=1)
    t = ShardedDMARuntime(num_shards=num_shards, device="cpu", **kw)
    tk = ShardedKVPool(t, num_pages=num_pages, page=row, kv_heads=1,
                       head_dim=1)
    _fill(j, jk, content, jnp.asarray)
    _fill(t, tk, content, torch.from_numpy)
    return (j, jk), (t, tk), content


def _det(stats):
    """A runtime's stats() without its wall-clock fields."""
    out = dict(stats)
    out.pop("launch_us_per_descriptor", None)
    out["channels"] = {n: {k: v for k, v in c.items()
                           if k != "drain_seconds"}
                       for n, c in stats["channels"].items()}
    return out


def assert_same(ref, port):
    (j, jk), (t, tk) = ref, port
    for name in (tk.POOL_K, tk.POOL_V):
        np.testing.assert_array_equal(t.gather_pool(name), j.gather_pool(name))
    js, ts = j.stats(), t.stats()
    assert [_det(s) for s in ts.pop("shards")] == \
        [_det(s) for s in js.pop("shards")]
    assert ts == js
    assert tk._free == jk._free
    assert tk.first_touch_pulls == jk.first_touch_pulls
    for k, v in tk.table.snapshot().items():
        np.testing.assert_array_equal(v, jk.table.snapshot()[k])
    # Staging buffers never outlive their hops.
    assert all(set(rt.pools) == {tk.POOL_K, tk.POOL_V} for rt in t.shards)


def _waves(kv, src, dst, wave):
    return [kv.move_pages(kv.refs(src[i:i + wave]), kv.refs(dst[i:i + wave]),
                          priority=1, drain=False)
            for i in range(0, len(src), wave)]


@pytest.mark.parametrize("fabric", ["async", "sync"])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_move_pages_equals_reference(shards, fabric):
    """Zipf-hot pages onto cold ones, the cells' way (waves of 8 left on
    the fabric, then pumped) and as one plan: pools, stats, fabric."""
    spec = DEFAULT_SHARDED_SPEC
    ref, port, content = _pair(shards, 16, 16, seed=shards, fabric=fabric)
    rng = np.random.default_rng([shards, 5])
    src, dst = _zipf_moves(rng, 16 * shards, 24, spec.zipf_alpha, 64)
    src, dst = src.tolist(), dst.tolist()
    plans = []
    for srt, kv in (ref, port):
        if fabric == "async":
            waves = _waves(kv, src[:16], dst[:16], 8)
            srt.pump_until_idle()
            srt.drain_until_idle()
        else:
            waves = [kv.move_pages(kv.refs(src[:16]), kv.refs(dst[:16]))]
        one = kv.move_pages(kv.refs(src[16:]), kv.refs(dst[16:]))
        plans.append([dataclasses.asdict(s) for s in waves + [one]])
    assert plans[0] == plans[1]
    assert_same(ref, port)
    agg = port[0].migration
    assert agg.hop_completions == agg.hops
    assert (agg.hops > 0) == (shards > 1)
    want = content.copy()
    want[dst] = content[src]
    np.testing.assert_array_equal(
        port[0].gather_pool(port[1].POOL_K).reshape(want.shape), want)


def test_single_shard_migration_bit_identical_to_unsharded_runtime():
    rng = np.random.default_rng(11)
    num_pages, row_elems = 32, 16
    content = rng.standard_normal(num_pages * row_elems).astype(np.float32)
    srt = ShardedDMARuntime(num_shards=1, data_channels=2, max_len=512,
                            device="cpu")
    kv = ShardedKVPool(srt, num_pages=num_pages, page=row_elems,
                       kv_heads=1, head_dim=1)
    for p, ref in enumerate(kv.refs(range(num_pages))):
        row = content[p * row_elems:(p + 1) * row_elems]
        kv.write_page(ref, row, -row)
    src = [3, 4, 5, 9, 20, 21, 22, 23, 7]
    dst = [12, 13, 14, 26, 0, 1, 2, 28, 30]
    kv.move_pages(kv.refs(src), kv.refs(dst))
    rt = DMARuntime([
        ChannelConfig(name="dma0", tier="serial", ring_capacity=256,
                      max_len=512),
        ChannelConfig(name="dma1", tier="serial", ring_capacity=256,
                      max_len=512),
        ChannelConfig(name="completion", tier="control"),
    ], device="cpu")
    pad = torch.zeros(512)
    rt.register_pool("kv.k", torch.cat([torch.from_numpy(content), pad]))
    rt.register_pool("kv.v", torch.cat([torch.from_numpy(-content), pad]))
    s = np.asarray(src, np.int64) * row_elems
    t = np.asarray(dst, np.int64) * row_elems
    ln = np.full(len(src), row_elems, np.int64)
    for name in ("kv.k", "kv.v"):
        rt.submit(SubmitRequest(chain=from_segments(s, t, ln),
                                src_pool=name, dst_pool=name, tier="serial"))
    rt.drain_until_idle()
    logical = num_pages * row_elems
    for name in ("kv.k", "kv.v"):
        np.testing.assert_array_equal(srt.gather_pool(name),
                                      rt.pool(name)[:logical].numpy())


@pytest.mark.parametrize("mode", ["copy", "remap"])
def test_defragment_under_churn_equals_reference(mode):
    ref, port, content = _pair(4, 16, 8, seed=7)
    outs = []
    for srt, kv in (ref, port):
        pages = kv.alloc_on(3, 5) + kv.alloc_on(1, 3) + kv.alloc_on(2, 4)
        kv.release(pages[2:6])
        live = pages[:2] + pages[6:]
        perm = np.random.default_rng(5).permutation(len(live))
        live = [live[i] for i in perm]
        before = kv.page_rows(live)
        new, stats, rate = kv.defragment(live, mode=mode)
        after = kv.page_rows(new)
        np.testing.assert_array_equal(after[0], before[0])
        np.testing.assert_array_equal(after[1], before[1])
        outs.append((_ints(new), dataclasses.asdict(stats), rate))
    assert outs[0] == outs[1]
    if mode == "remap":
        assert outs[1][1] == dataclasses.asdict(MigrationStats())
    else:
        assert outs[1][1]["pages"] == len(outs[1][0])
    assert outs[1][2] == 1.0
    assert_same(ref, port)


def test_migration_chains_correct_under_defrag_churn():
    ref, port, content = _pair(4, 16, 8, seed=5)
    rng = np.random.default_rng(5)
    freed = rng.random(64) < 0.35
    live, free = np.flatnonzero(~freed), np.flatnonzero(freed)
    n = min(24, len(free))
    src, dst = live[-n:].tolist(), free[:n].tolist()
    stats = [kv.move_pages(kv.refs(src), kv.refs(dst)) for _, kv in
             (ref, port)]
    assert dataclasses.asdict(stats[0]) == dataclasses.asdict(stats[1])
    st = stats[1]
    assert st.cross_pages > 0 and st.hops > 0
    assert st.hop_completions == st.hops and st.merge_ratio >= 1.0
    assert_same(ref, port)
    want = content.copy()
    want[dst] = content[src]
    np.testing.assert_array_equal(
        port[0].gather_pool(port[1].POOL_V).reshape(64, 8), -want)


def _ints(pages):
    return [int(p) for p in pages]


def test_flip_ownership_with_first_touch_pulls_equals_reference():
    ref, port, content = _pair(4, 16, 8, seed=9)
    outs = []
    for srt, kv in (ref, port):
        pages = kv.alloc_on(0, 6)
        flipped = kv.flip_ownership(pages, 2)
        assert [kv.owner_of(p) for p in flipped] == [2] * 6
        assert len(kv.table.pending_pages()) == 6
        k, _ = kv.page_rows([flipped[0]])         # the first touch
        np.testing.assert_array_equal(k[0], content[int(pages[0])])
        pulled_one = kv.first_touch_pulls
        r0 = srt.fabric.now
        kv.ensure_resident(flipped[1:4], priority=1)
        stats = kv.move_pages(flipped[4:], kv.alloc_on(3, 2))
        outs.append((_ints(flipped), [r.generation for r in flipped],
                     pulled_one, kv.first_touch_pulls, srt.fabric.now - r0,
                     dataclasses.asdict(stats), kv.table.generation,
                     kv.table.remaps))
    assert outs[0] == outs[1]
    assert outs[1][2] == 1 and outs[1][3] == 6
    assert_same(ref, port)


def test_migration_stats_merge_empty_move_and_rejections():
    srt = ShardedDMARuntime(num_shards=2, device="cpu")
    kv = ShardedKVPool(srt, num_pages=8, page=4, kv_heads=1, head_dim=1)
    assert kv.move_pages([], []) == MigrationStats()
    with pytest.raises(ValueError, match="pair up"):
        kv.move_pages(kv.refs([1]), kv.refs([2, 3]))
    with pytest.raises(ValueError, match="reads and writes"):
        kv.move_pages(kv.refs([0, 5]), kv.refs([5, 0]))
    with pytest.raises(ValueError, match="duplicate destination"):
        kv.move_pages(kv.refs([0, 1]), kv.refs([6, 6]))
    a = MigrationStats(pages=2, hops=1, chain_in=4, chain_out=2)
    a.merge(MigrationStats(pages=1, chain_in=2, chain_out=1,
                           fabric_inflight_rounds=4, fabric_hidden_rounds=3))
    assert (a.pages, a.merge_ratio, a.overlap_ratio) == (3, 2.0, 0.75)


# ---------------------------------------------------------------------------
# Storage isolation: the port's drains write pools in place
# ---------------------------------------------------------------------------

def _storages(srt):
    return [t.untyped_storage().data_ptr()
            for rt in srt.shards for t in rt.pools.values()]


def test_pools_are_fresh_tensors_never_views_of_the_caller_or_each_other():
    srt = ShardedDMARuntime(num_shards=4, device="cpu")
    owner = PageOwnerMap(16, 4)
    arr = torch.arange(16 * 4, dtype=torch.float32)
    srt.register_sharded_pool("x", arr, owner, 4)
    srt.register_sharded_pool("y", arr.numpy(), owner, 4)
    arr.add_(1000.0)                               # the caller writes on
    for name in ("x", "y"):
        np.testing.assert_array_equal(srt.gather_pool(name),
                                      np.arange(64, dtype=np.float32))
    kv = ShardedKVPool(srt, num_pages=16, page=4, kv_heads=1, head_dim=1)
    ptrs = _storages(srt)
    assert len(ptrs) == len(set(ptrs)) == 4 * 4
    # A write to K (in place, on a shard's pool) leaves V alone...
    srt.shards[1].pool(kv.POOL_K)[:4] = 7.0
    assert not srt.gather_pool(kv.POOL_V).any()
    # ...and so does a K-only migration, on every route of the drain.
    srt.migrate_rows((kv.POOL_K,), [4, 5, 1], [12, 9, 2])
    np.testing.assert_array_equal(srt.gather_pool(kv.POOL_K)[48:52],
                                  np.full(4, 7.0))
    assert not srt.gather_pool(kv.POOL_V).any()
    # gather_pool and page_rows hand out copies, never live views.
    got = srt.gather_pool(kv.POOL_K)
    k, _ = kv.page_rows(kv.refs([4]))
    srt.shards[1].pool(kv.POOL_K)[:8] = -1.0
    assert got[16] == 7.0 and k[0, 0] == 7.0


@pytest.mark.parametrize("fabric", ["async", "sync"])
def test_staging_buffers_live_exactly_as_long_as_their_hop(fabric):
    ref, port, content = _pair(2, 8, 4, seed=2, fabric=fabric)
    srt, kv = port
    if fabric == "sync":
        seen = []
        real = srt._submit_hop

        def spy(*a, **k):
            real(*a, **k)
            seen.append([sorted(rt.pools) for rt in srt.shards])
        srt._submit_hop = spy
        kv.move_pages(kv.refs([1, 2]), kv.refs([9, 10]))
        assert seen == [[[kv.POOL_K, kv.POOL_V]] * 2]
    else:
        kv.move_pages(kv.refs([1, 2]), kv.refs([9, 10]), drain=False)
        (t,) = srt._pending_hops
        stages = {srt._stage_name(t.hop_id, n) for n in t.pool_names}
        assert stages <= set(srt.shards[0].pools)     # egress window
        ptrs = _storages(srt)
        assert len(ptrs) == len(set(ptrs))
        while t.state == "egress":
            srt.pump()
        assert not stages & set(srt.shards[0].pools)  # sent
        assert set(t.staged) == set(t.pool_names)
        srt.pump_until_idle()
        assert t.state == "completed" and not t.staged
        assert all(not stages & set(rt.pools) for rt in srt.shards)
    ref[1].move_pages(ref[1].refs([1, 2]), ref[1].refs([9, 10]))
    assert all(not any(n.startswith(STAGE) for n in rt.stats()["channels"])
               for rt in srt.shards)
    assert_same(ref, port)
    with pytest.raises(ValueError, match="reserved"):
        srt.register_sharded_pool(STAGE, torch.zeros(8), kv.owner, 2)
    with pytest.raises(ValueError, match="expected flat"):
        srt.register_sharded_pool("z", torch.zeros(7), kv.owner, 2)


# ---------------------------------------------------------------------------
# Sharded serving against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = (dataclasses.replace(get("qwen2.5-3b", reduced=True),
                                      compute_dtype="float32")
                  for get in (jget_config, get_config))
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return (jp, jcfg), (tp, tcfg)


def _counters(pc):
    """perf_counters() without wall-clock fields."""
    out = dict(pc)
    out["sharded.per_shard"] = [
        {k: v for k, v in p.items() if k != "serve.step_seconds"}
        for p in pc["sharded.per_shard"]]
    return out


def _serve(pkg, params, cfg, shards, capacity, max_len, plan):
    srt_cls, kv_cls, eng_cls, sub, req_cls, kw = pkg
    srt = srt_cls(num_shards=shards, **kw)
    kv = kv_cls(srt, num_pages=32 * shards, page=2, kv_heads=2, head_dim=4)
    eng = eng_cls(params, cfg, runtime=srt, kv_pool=kv, capacity=capacity,
                  max_len=max_len)
    routed, order = [], []
    for uid, prompt, new, homes in plan:
        pages = [p for s, n in homes for p in kv.alloc_on(s, n)]
        r = req_cls(uid=uid, prompt=list(prompt), max_new_tokens=new,
                    kv_pages=pages)
        routed.append((eng.submit(sub(request=r)).shard,
                       _ints(r.kv_pages), eng.remote_page_reads))
    while any(e.queue or any(s.busy for s in e.slots) for e in eng.engines):
        eng.step()
        order.extend(r.uid for r in eng.poll_completed()
                     if r.uid not in order)
    done = eng.run()
    return (routed, order, {u: list(r.output) for u, r in done.items()},
            _counters(eng.perf_counters()), srt.gather_pool(kv.POOL_K),
            dataclasses.asdict(eng.migration))


JPKG = (JSRT, JKV, JSharded, JSubmitRequest, JRequest, {})
TPKG = (ShardedDMARuntime, ShardedKVPool, ShardedServeEngine, SubmitRequest,
        Request, {"device": "cpu"})


def _plan(seed, n, shards, vocab=512):
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n):
        prompt = [int(t) for t in rng.integers(1, vocab,
                                               int(rng.integers(2, 7)))]
        home = uid % shards
        homes = [(home, 2)]
        if uid % 3 == 2:           # straddle: the minority page migrates
            homes.append(((home + 1) % shards, 1))
        if uid % 4 == 3:           # a majority elsewhere: two pages pulled
            homes = [(home, 2), ((home + 1) % shards, 3)]
        out.append((uid, prompt, int(rng.integers(2, 5)), homes))
    return out


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_serve_equals_the_reference(weights, shards):
    (jp, jcfg), (tp, tcfg) = weights
    plan = _plan(shards, 2 * shards + 2, shards)
    want = _serve(JPKG, jp, jcfg, shards, 2, 24, plan)
    got = _serve(TPKG, tp, tcfg, shards, 2, 24, plan)
    routed, order, outputs, counters, pool, migration = got
    assert routed == want[0]
    assert order == want[1] and sorted(order) == list(range(len(plan)))
    assert outputs == want[2]
    assert counters == want[3]
    np.testing.assert_array_equal(pool, want[4])
    assert migration == want[5]
    assert counters["sharded.remote_page_reads"] == \
        counters["sharded.migration"]["pages"] > 0
    assert counters["sharded.migration"]["hop_completions"] == \
        counters["sharded.migration"]["hops"]
    assert counters["sharded.completed"] == len(plan)


def test_sharded_serve_routes_by_ownership_and_migrates_remote_pages(
        weights):
    _, (params, cfg) = weights
    srt = ShardedDMARuntime(num_shards=2, device="cpu")
    kv = ShardedKVPool(srt, num_pages=32, page=2, kv_heads=2, head_dim=4)
    eng = ShardedServeEngine(params, cfg, runtime=srt, kv_pool=kv,
                             capacity=1, max_len=32)
    for uid in range(4):
        t = eng.submit(SubmitRequest(request=Request(
            uid=uid, prompt=[1, 2, 3], max_new_tokens=2,
            kv_pages=kv.alloc_on(uid % 2, 2))))
        assert t.shard == uid % 2
    assert eng.remote_page_reads == 0
    mixed = Request(uid=9, prompt=[4, 5], max_new_tokens=2,
                    kv_pages=kv.alloc_on(0, 1) + kv.alloc_on(1, 2))
    assert eng.submit(SubmitRequest(request=mixed)).shard == 1
    assert eng.remote_page_reads == 1
    assert eng.migration.pages == 1 and eng.migration.hops == 1
    assert all(kv.owner.owner(p) == 1 for p in mixed.kv_pages)
    free_before = [kv.free_pages_on(s) for s in range(2)]
    p0b = kv.alloc_on(0, 1)
    dup = Request(uid=10, prompt=[6], max_new_tokens=2,
                  kv_pages=p0b + p0b + kv.alloc_on(1, 3))
    assert eng.submit(SubmitRequest(request=dup)).shard == 1
    assert len(set(dup.kv_pages)) == 4
    kv.release(sorted(set(dup.kv_pages)))
    assert [kv.free_pages_on(s) for s in range(2)] == free_before
    done = eng.run(max_steps=200)
    assert sorted(done) == [0, 1, 2, 3, 9, 10]
    assert len(eng.poll_completed()) == 6
    pc = eng.perf_counters()
    assert pc["sharded.requests_per_shard"] == [2, 4]
    assert pc["sharded.completed"] == 6


def test_shared_page_not_freed_while_another_request_reads_it(weights):
    _, (params, cfg) = weights
    srt = ShardedDMARuntime(num_shards=2, device="cpu")
    kv = ShardedKVPool(srt, num_pages=16, page=2, kv_heads=2, head_dim=4)
    eng = ShardedServeEngine(params, cfg, runtime=srt, kv_pool=kv,
                             capacity=2, max_len=16)
    (p,) = kv.alloc_on(0, 1)
    kv.write_page(p, np.full(kv.row_elems, 7.0), np.full(kv.row_elems, 7.0))
    eng.submit(SubmitRequest(request=Request(uid=0, prompt=[1],
                                             max_new_tokens=1, kv_pages=[p])))
    eng.submit(SubmitRequest(request=Request(
        uid=1, prompt=[2], max_new_tokens=1,
        kv_pages=[p] + kv.alloc_on(1, 2))))
    assert p not in kv._free[0]
    np.testing.assert_array_equal(kv.page_rows([p])[0][0],
                                  np.full(kv.row_elems, 7.0))
    eng.run(max_steps=50)
    eng.poll_completed()
    assert kv._free[0].count(p) == 1


def test_migration_hop_does_not_steal_serve_completion_events(weights):
    _, (params, cfg) = weights
    srt = ShardedDMARuntime(num_shards=2, device="cpu")
    kv = ShardedKVPool(srt, num_pages=16, page=2, kv_heads=2, head_dim=4)
    eng = ShardedServeEngine(params, cfg, runtime=srt, kv_pool=kv,
                             capacity=1, max_len=16)
    eng.submit(SubmitRequest(request=Request(uid=0, prompt=[1],
                                             max_new_tokens=1,
                                             kv_pages=kv.alloc_on(1, 1))))
    for _ in range(10):
        eng.step()
        if 0 in eng.engines[1].completed:
            break
    assert 0 in eng.engines[1].completed
    b = Request(uid=1, prompt=[2], max_new_tokens=1,
                kv_pages=kv.alloc_on(0, 1) + kv.alloc_on(1, 2))
    assert eng.submit(SubmitRequest(request=b)).shard == 1
    assert eng.migration.hops == 1
    assert 0 in {r.uid for r in eng.poll_completed()}


def test_sharded_serve_submit_requires_submit_request(weights):
    _, (params, cfg) = weights
    srt = ShardedDMARuntime(num_shards=2, device="cpu")
    kv = ShardedKVPool(srt, num_pages=16, page=2, kv_heads=2, head_dim=4)
    eng = ShardedServeEngine(params, cfg, runtime=srt, kv_pool=kv,
                             capacity=1, max_len=32)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        t = eng.submit(SubmitRequest(request=Request(
            uid=0, prompt=[1, 2], max_new_tokens=2,
            kv_pages=kv.alloc_on(1, 2))))
    assert isinstance(t, Ticket) and t.shard == 1 and t.uid == 0
    with pytest.raises(TypeError, match="ShardedServeEngine.submit"):
        eng.submit(Request(uid=1, prompt=[3], max_new_tokens=2))
    with pytest.raises(ValueError, match="SubmitRequest.request"):
        eng.submit(SubmitRequest())
    other = ShardedDMARuntime(num_shards=2, device="cpu")
    with pytest.raises(ValueError, match="same sharded runtime"):
        ShardedServeEngine(params, cfg, runtime=other, kv_pool=kv)
    t2 = eng.submit(SubmitRequest(request=Request(
        uid=1, prompt=[3], max_new_tokens=2, kv_pages=kv.alloc_on(0, 2))))
    assert t2.shard == 0
    assert sorted(eng.run(max_steps=200)) == [0, 1]
    pc = eng.perf_counters()
    assert pc["sharded.completed"] == 2
    assert pc["sharded.requests_per_shard"] == [1, 1]
    with pytest.raises(KeyError):
        pc["requests_per_shard"]
    assert all("." in k or k == "translation" for k in pc)


def test_recorded_sharded_trace_equals_the_reference():
    """``obs.record`` at mesh 2: the same counters, tracks and event names
    as the reference's recorder on the same seed."""
    tracer, probe, pc = record_serve_trace(0, mesh=2, device="cpu")
    jtracer, jprobe, jpc = jrecord(0, mesh=2)
    assert pc["sharded.remote_page_reads"] == 2
    for k in ("sharded.requests_per_shard", "sharded.remote_page_reads",
              "sharded.migration", "sharded.completed",
              "sharded.request_latency_steps"):
        assert pc[k] == jpc[k], k
    tracks = {e.track for e in tracer.events()}
    assert tracks == {e.track for e in jtracer.events()}
    assert {"shard0/migrate", "shard1/migrate", "fabric"} <= tracks
    names = {e.name for e in tracer.events()}
    assert names == {e.name for e in jtracer.events()}
    assert probe.metrics_snapshot()["request_latency_steps"]["n"] == 6
