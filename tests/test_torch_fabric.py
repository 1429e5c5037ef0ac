"""Port parity: the async fabric, the rebalance planner and elastic resize.

The port's ``distributed.fabric`` is a copy of the reference's (numpy
only), so every unit here runs the same inputs through both packages and
asserts equal results; the runtime-level cases (async vs sync fabric, the
pump, overlap accounting, priorities, evacuate/readmit and shard loss with
tickets in flight) hold the port's pools bit for bit, and its migration
stats, fabric counters and remaps exactly, against the reference on the
same seeded contents. Everything runs on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import fabric as jfab  # noqa: E402
from repro.distributed.fault import ungraceful_resize as jresize  # noqa: E402
from repro.distributed.sharded_runtime import (  # noqa: E402
    ShardedDMARuntime as JSRT,
    ShardedKVPool as JKV,
)
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro_torch.distributed import fabric as tfab  # noqa: E402
from repro_torch.distributed.fault import ungraceful_resize  # noqa: E402
from repro_torch.distributed.sharded_runtime import (  # noqa: E402
    ShardedDMARuntime,
    ShardedKVPool,
)
from repro_torch.obs.trace import Tracer  # noqa: E402

# ---------------------------------------------------------------------------
# FabricLink / AsyncFabric units, both packages on the same sends
# ---------------------------------------------------------------------------

def _link_trace(fab):
    ln = fab.FabricLink(0, 1, latency=2, page_beats=3)
    delivered = [ln.send(0, 2), ln.send(1, 1), ln.send(20, 0)]
    return delivered, dataclasses.asdict(ln)


def test_fabric_link_occupancy_and_queueing_math():
    delivered, state = _link_trace(tfab)
    # Idle link: deliver = now + latency + pages * page_beats; a busy link
    # queues the next send; a zero-page payload still costs one beat.
    assert delivered == [8, 13, 25]
    assert (state["sends"], state["pages_sent"], state["queued_rounds"]) \
        == (3, 3, 7)
    assert state["busy_rounds"] == 8 + 5 + 5
    assert (delivered, state) == _link_trace(jfab)


def _ticket(fab, hop_id, src, dst, pages, priority=0):
    return fab.FabricTicket(
        hop_id=hop_id, src_shard=src, dst_shard=dst, pages=pages,
        pool_names=("kv.k",), rows_s=np.zeros(pages, np.int64),
        rows_d=np.zeros(pages, np.int64), ctrl_ticket=0, stats=None,
        priority=priority)


def _fabric_trace(fab):
    f = fab.AsyncFabric(latency=1, page_beats=1)
    t = _ticket(fab, 1, 0, 1, pages=2)
    out = [f.send(t), t.state, f.occupied_links(), len(f.deliveries())]
    for _ in range(3):
        f.advance()
    got = f.deliveries()
    out += [[x.hop_id for x in got], t.state, f.occupied_links(),
            len(f.in_flight)]
    f.send(_ticket(fab, 2, 1, 0, pages=1))
    f.send(_ticket(fab, 3, 0, 1, pages=4))
    out += [f.link_stats(), f.now]
    return out


def test_async_fabric_clock_links_and_deliveries():
    got = _fabric_trace(tfab)
    assert got[:8] == [3, tfab.IN_FLIGHT, 1, 0, [1], tfab.INGRESS, 0, 0]
    assert [(s["src"], s["dst"]) for s in got[8]] == [(0, 1), (1, 0)]
    assert got == _fabric_trace(jfab)
    assert (tfab.EGRESS, tfab.IN_FLIGHT, tfab.INGRESS, tfab.COMPLETED) == \
        (jfab.EGRESS, jfab.IN_FLIGHT, jfab.INGRESS, jfab.COMPLETED)
    for kw in ({"latency": -1}, {"page_beats": 0}):
        with pytest.raises(ValueError):
            tfab.AsyncFabric(**kw)


# ---------------------------------------------------------------------------
# RebalancePlanner: hysteresis, heat decay, spreading plan, placement
# ---------------------------------------------------------------------------

def _hysteresis(fab):
    pl = fab.RebalancePlanner(2, window=2, high_water=1.5, low_water=1.1)
    trace = []
    for load in ([10.0, 10.0], [40.0, 10.0], [40.0, 10.0], [13.0, 10.0],
                 [13.0, 10.0], [10.0, 10.0], [10.0, 10.0]):
        pl.observe(load)
        trace.append((pl.imbalance(), pl.should_rebalance()))
    return trace


def test_planner_hysteresis_opens_high_closes_low():
    trace = _hysteresis(tfab)
    # Opens above high_water, holds in the dead band, closes under low.
    assert [open_ for _, open_ in trace] == \
        [False, False, True, True, True, False, False]
    assert trace[2][0] > 1.5 and 1.1 < trace[4][0] < 1.5
    assert trace[5][0] <= 1.1
    assert trace == _hysteresis(jfab)


def test_planner_heat_decays_to_nothing_without_traffic():
    for fab in (tfab, jfab):
        pl = fab.RebalancePlanner(2, heat_decay=0.5)
        pl.observe([1.0, 1.0], hot_pages=[5])
        assert pl.page_heat == {5: 1.0}
        for _ in range(5):
            pl.observe([1.0, 1.0])
        assert pl.page_heat == {}
    for kw in ({"num_shards": 0}, {"low_water": 2.0}, {"window": 0},
               {"heat_decay": 1.0}):
        args = {"num_shards": 2, **kw}
        with pytest.raises(ValueError):
            tfab.RebalancePlanner(**args)


def _pools(num_shards, num_pages, row=4, **kw):
    j = JSRT(num_shards=num_shards, **kw)
    jk = JKV(j, num_pages=num_pages, page=row, kv_heads=1, head_dim=1)
    t = ShardedDMARuntime(num_shards=num_shards, device="cpu", **kw)
    tk = ShardedKVPool(t, num_pages=num_pages, page=row, kv_heads=1,
                       head_dim=1)
    return (j, jk), (t, tk)


def _ints(pages):
    return [int(p) for p in pages]


def test_planner_plan_spreads_hot_pages_across_all_receivers():
    out = []
    for fab, (_, kv) in zip((jfab, tfab), _pools(4, 64)):
        pl = fab.RebalancePlanner(4, window=2)
        hot = kv.alloc_on(0, 6)
        for _ in range(3):
            pl.observe([100.0, 10.0, 10.0, 10.0], hot_pages=hot)
        src, dst = pl.plan(kv)
        assert sorted(src) == sorted(hot)
        assert {kv.owner.owner(p) for p in dst} == {1, 2, 3}
        assert (pl.plans_emitted, pl.pages_planned) == (1, 6)
        out.append((_ints(src), _ints(dst), kv._free))
    assert out[0] == out[1]


def test_planner_overshoot_guard_blocks_ping_pong_moves():
    for fab, (_, kv) in zip((jfab, tfab), _pools(4, 64)):
        pl = fab.RebalancePlanner(4, window=2)
        (page,) = kv.alloc_on(0, 1)
        for _ in range(2):
            pl.observe([60.0, 30.0, 30.0, 30.0], hot_pages=[page] * 20)
        assert pl.should_rebalance()
        assert pl.plan(kv) is None and pl.plans_emitted == 0


def test_planner_placement_and_ownership_plans_equal_reference():
    out = []
    for fab, (_, kv) in zip((jfab, tfab), _pools(4, 64)):
        kv.alloc_on(1, 12)
        kv.alloc_on(2, 8)
        pl = fab.RebalancePlanner(4)
        dst = pl.placement(kv, list(range(6)), survivors=[1, 2, 3])
        owners = [kv.owner.owner(p) for p in dst]
        assert owners.count(3) > owners.count(1)
        assert len(set(dst)) == 6
        with pytest.raises(ValueError, match="at least one survivor"):
            pl.placement(kv, [0], survivors=[])
        own = fab.RebalancePlanner(4, window=2)
        hot = kv.alloc_on(0, 5)
        for _ in range(2):
            own.observe([90.0, 10.0, 20.0, 10.0], hot_pages=hot)
        pages, shards = own.plan_ownership(kv)
        out.append((_ints(dst), _ints(pages), list(shards),
                    own.pages_planned))
    assert out[0] == out[1]


def test_seeded_planner_trace_equals_reference():
    """Forty seeded load samples through both planners over live pools:
    every emitted plan (pages and destinations), the episode state and the
    heat table agree step for step."""
    traces = []
    for fab, (_, kv) in zip((jfab, tfab), _pools(4, 64)):
        rng = np.random.default_rng(17)
        pl = fab.RebalancePlanner(4, window=3, max_pages_per_plan=4)
        live = kv.alloc_on(0, 12) + kv.alloc_on(1, 4)
        trace = []
        for _ in range(40):
            load = rng.gamma(2.0, 10.0, 4) * np.array([4.0, 1.0, 1.0, 1.0])
            hot = rng.choice(np.asarray(live, np.int64), 8)
            pl.observe(load.tolist(), hot_pages=hot.tolist())
            plan = pl.plan(kv)
            trace.append((None if plan is None
                          else (_ints(plan[0]), _ints(plan[1])),
                          pl.should_rebalance(),
                          sorted(pl.page_heat.items())))
        traces.append(trace)
    assert traces[0] == traces[1]
    assert any(step[0] is not None for step in traces[1])


# ---------------------------------------------------------------------------
# Async fabric through the sharded runtime, against the reference
# ---------------------------------------------------------------------------

def _filled(num_shards, num_pages, row=8, seed=0, **kw):
    """Both packages' runtimes over one seeded content (K = c, V = -c)."""
    content = np.random.default_rng(seed).standard_normal(
        (num_pages, row)).astype(np.float32)
    (j, jk), (t, tk) = _pools(num_shards, num_pages, row, **kw)
    for rt, kv, conv in ((j, jk, jnp.asarray), (t, tk, torch.from_numpy)):
        for name, c in ((kv.POOL_K, content), (kv.POOL_V, -content)):
            rt.register_sharded_pool(name, conv(c.reshape(-1).copy()),
                                     kv.owner, kv.row_elems)
    return (j, jk), (t, tk), content


def _fabric_state(rt):
    if rt.fabric is None:
        return None
    return (rt.fabric.now, len(rt._pending_hops), rt.fabric.link_stats())


def assert_same(ref, port):
    """Pools bit for bit, mesh aggregate, fabric, ownership state."""
    (j, jk), (t, tk) = ref, port
    for name in (tk.POOL_K, tk.POOL_V):
        np.testing.assert_array_equal(t.gather_pool(name), j.gather_pool(name))
    assert dataclasses.asdict(t.migration) == dataclasses.asdict(j.migration)
    assert _fabric_state(t) == _fabric_state(j)
    assert t.active == j.active
    assert tk._free == jk._free
    assert tk.first_touch_pulls == jk.first_touch_pulls
    for k, v in tk.table.snapshot().items():
        np.testing.assert_array_equal(v, jk.table.snapshot()[k])


def test_async_and_sync_fabric_agree_on_contents_and_plan_shape():
    src = [1, 2, 3, 17, 18, 40, 41, 42, 9]
    dst = [33, 34, 35, 50, 51, 10, 11, 12, 28]
    outs = {}
    for mode in ("async", "sync"):
        ref, port, _ = _filled(4, 64, seed=3, fabric=mode)
        stats = [kv.move_pages(src, dst) for _, kv in (ref, port)]
        assert dataclasses.asdict(stats[0]) == dataclasses.asdict(stats[1])
        assert_same(ref, port)
        outs[mode] = (port[0].gather_pool(port[1].POOL_K), stats[1])
    np.testing.assert_array_equal(outs["async"][0], outs["sync"][0])
    a, s = outs["async"][1], outs["sync"][1]
    assert (a.pages, a.cross_pages, a.local_pages, a.hops) == \
        (s.pages, s.cross_pages, s.local_pages, s.hops)
    assert a.hop_completions == a.hops == s.hop_completions
    assert s.fabric_inflight_rounds == 0 and s.overlap_ratio == 0.0


def test_sync_fabric_rejects_pump_and_has_no_fabric_object():
    _, (srt, kv), _ = _filled(2, 16, fabric="sync")
    assert srt.fabric is None
    with pytest.raises(RuntimeError, match="requires fabric='async'"):
        srt.pump()
    with pytest.raises(RuntimeError, match="requires fabric='async'"):
        ungraceful_resize(kv, 0)
    with pytest.raises(ValueError, match="fabric must be"):
        ShardedDMARuntime(num_shards=2, fabric="bogus", device="cpu")


def test_drain_false_leaves_tickets_for_the_caller_to_pump():
    ref, port, content = _filled(2, 32, seed=1)
    plans = []
    for srt, kv in (ref, port):
        stats = kv.move_pages([1, 2, 3], [20, 21, 22], drain=False)
        assert srt.fabric_outstanding() == srt.plan_outstanding(stats) == 1
        assert stats.hop_completions == 0
        srt.pump_until_idle()
        srt.drain_until_idle()
        assert srt.fabric_outstanding() == srt.plan_outstanding(stats) == 0
        assert stats.hop_completions == stats.hops == 1
        assert srt.migration.hop_completions == 1
        plans.append(dataclasses.asdict(stats))
    assert plans[0] == plans[1]
    assert_same(ref, port)
    want = content.copy()
    want[[20, 21, 22]] = content[[1, 2, 3]]
    np.testing.assert_array_equal(
        port[0].gather_pool(port[1].POOL_K).reshape(32, 8), want)


def test_overlap_rounds_are_global_not_per_plan():
    ref, port, _ = _filled(2, 32, seed=2)
    for srt, kv in (ref, port):
        plans = [kv.move_pages([1 + i], [16 + i], drain=False)
                 for i in range(4)]
        srt.pump_until_idle()
        srt.drain_until_idle()
        agg = srt.migration
        assert agg.fabric_inflight_rounds > 0
        assert 0 <= agg.fabric_hidden_rounds <= agg.fabric_inflight_rounds
        for st in plans:
            assert st.fabric_inflight_rounds == st.fabric_hidden_rounds == 0
            assert st.hop_completions == st.hops == 1
    assert_same(ref, port)


def test_priority_orders_link_access_between_ready_tickets():
    ref, port, _ = _filled(2, 32, seed=4)
    rounds = []
    for srt, kv in (ref, port):
        bg = srt.migrate_rows((kv.POOL_K,), [1], [20], drain=False,
                              priority=0)
        fg = srt.migrate_rows((kv.POOL_K,), [2], [21], drain=False,
                              priority=1)
        tickets = {t.priority: t for t in srt._pending_hops}
        srt.pump_until_idle()
        assert tickets[1].sent_round == tickets[0].sent_round
        assert tickets[1].deliver_round < tickets[0].deliver_round
        assert srt.fabric.link(0, 1).queued_rounds > 0
        assert bg.hop_completions == fg.hop_completions == 1
        rounds.append([(t.sent_round, t.deliver_round, t.completed_round,
                        t.inflight_rounds, t.hidden_rounds)
                       for _, t in sorted(tickets.items())])
    assert rounds[0] == rounds[1]
    assert_same(ref, port)


def test_fabric_hops_emit_the_reference_trace_events():
    ref, port, _ = _filled(2, 16, seed=5)
    seen = []
    for (srt, kv), tr in ((ref, JTracer()), (port, Tracer())):
        srt.attach_tracer(tr)
        kv.move_pages([1, 2], [10, 11])
        seen.append(sorted((e.name, e.track, e.ph) for e in tr._buf))
        counters = [e for e in tr._buf
                    if e.ph == "C" and e.name.startswith("fabric.link")]
        assert any(e.args.get("pages_in_flight", 0) > 0 for e in counters)
        assert any(e.args.get("pages_in_flight") == 0 for e in counters)
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------------
# Elastic resize: graceful evacuate/readmit, and shard loss with tickets in
# flight, against the reference
# ---------------------------------------------------------------------------

def test_evacuate_readmit_roundtrip_preserves_contents():
    ref, port, content = _filled(4, 64, seed=6)
    remaps = []
    for srt, kv in (ref, port):
        live = kv.alloc_on(2, 5)
        remap = kv.evacuate(2)
        assert srt.active == [True, True, False, True]
        assert sorted(remap) == sorted(live)
        assert all(kv.owner.owner(p) != 2 for p in remap.values())
        with pytest.raises(RuntimeError, match="left the mesh"):
            kv.alloc_on(2, 1)
        remaps.append(remap)
    assert remaps[0] == remaps[1]
    assert_same(ref, port)
    for old, new in remaps[1].items():
        np.testing.assert_array_equal(port[1].page_rows([new])[0][0],
                                      content[old])
    for srt, kv in (ref, port):
        kv.readmit(2)
        assert srt.active == [True] * 4
        assert kv.free_pages_on(2) == len(list(kv.owner.shard_pages(2)))
    assert_same(ref, port)


@pytest.mark.parametrize("inject_round", [0, 1, 2, 3, 5])
def test_shard_loss_with_tickets_in_flight_loses_no_pages(inject_round):
    """Ungraceful resize while hops touching the lost shard sit at every
    lifecycle stage: the port's remap, pools, stats and fabric equal the
    reference's, and each migrated page lands exactly once."""
    lost = 1
    ref, port, content = _filled(4, 64, seed=7)
    runs = []
    for (srt, kv), resize in ((ref, jresize), (port, ungraceful_resize)):
        alloc = {s: kv.alloc_on(s, 8) for s in range(4)}
        moves = list(zip(alloc[0][:3], kv.alloc_on(lost, 3))) + \
            list(zip(alloc[lost][:3], kv.alloc_on(2, 3))) + \
            list(zip(alloc[3][:2], kv.alloc_on(0, 2)))
        src, dst = [list(x) for x in zip(*moves)]
        stats = kv.move_pages(src, dst, drain=False)
        assert stats.hops == 3
        srt.pump(inject_round)
        states = sorted(t.state for t in srt._pending_hops)
        remap = resize(kv, lost)
        assert srt.active == [True, False, True, True]
        assert srt.fabric_outstanding() == 0
        assert stats.hop_completions == stats.hops
        landed = list(remap.values())
        assert len(landed) == len(set(landed))
        assert all(kv.owner.owner(p) != lost for p in landed)
        runs.append((remap, dataclasses.asdict(stats), states, moves,
                     alloc))
    assert runs[0][:3] == runs[1][:3]
    assert_same(ref, port)
    (_, kv) = port
    remap, _, _, moves, alloc = runs[1]
    for s, d in moves:
        final = remap[d] if kv.owner.owner(d) == lost else d
        k, v = kv.page_rows([final])
        np.testing.assert_array_equal(k[0], content[s])
        np.testing.assert_array_equal(v[0], -content[s])
    for p in alloc[lost][3:]:
        np.testing.assert_array_equal(kv.page_rows([remap[p]])[0][0],
                                      content[p])
    for p in alloc[2][3:]:
        np.testing.assert_array_equal(kv.page_rows([p])[0][0], content[p])
    # No staging buffer outlives its hop, on any shard.
    assert not any(n.startswith(ShardedDMARuntime.STAGE_POOL)
                   for rt in port[0].shards for n in rt.pools)


def test_ungraceful_resize_rejects_already_left_shard():
    _, (srt, kv), _ = _filled(2, 16, seed=8)
    kv.evacuate(1)
    with pytest.raises(ValueError, match="already left"):
        ungraceful_resize(kv, 1)
    with pytest.raises(RuntimeError, match="no surviving shards"):
        ungraceful_resize(kv, 0)
