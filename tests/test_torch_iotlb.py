"""Port parity: the IOTLB model (DESIGN.md §11) and the cycle model with it.

``repro_torch.mmu.iotlb`` is a copy of the reference's over the port's
speculation policies. Its counts under a seeded lookup stream, and every
simulator result with an IOTLB, must equal the reference's.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import simulator as J  # noqa: E402
from repro.core import speculation as JS  # noqa: E402
from repro.mmu import IOTLB as JIOTLB  # noqa: E402
from repro.mmu import IOTLBParams as JParams  # noqa: E402
from repro.mmu import remap_cycles as jremap  # noqa: E402
from repro_torch.core import simulator as T  # noqa: E402
from repro_torch.core import speculation as TS  # noqa: E402
from repro_torch.core.speculation import AdaptiveDepth, FixedDepth  # noqa: E402
from repro_torch.mmu import (  # noqa: E402
    DEFAULT_WALK_CYCLES,
    IOTLB,
    IOTLBParams,
    remap_cycles,
)


def _stream(seed, n=600, pages=96):
    """Seeded (op, vpage, now) ops: mostly-sequential pages with jumps,
    prefetches ahead of the access point, and a few shootdowns."""
    rng = np.random.default_rng(seed)
    ops, page, now = [], 0, 0.0
    for _ in range(n):
        now += float(rng.integers(0, 12))
        r = rng.random()
        if r < 0.55:
            page = page + 1 if rng.random() < 0.8 else int(
                rng.integers(pages))
            ops.append(("access", page, now))
        elif r < 0.9:
            ops.append(("prefetch", page + int(rng.integers(1, 6)), now))
        else:
            ops.append(("invalidate", int(rng.integers(pages)), now))
    return ops


def _replay(tlb, ops):
    stalls = []
    for op, page, now in ops:
        if op == "access":
            stalls.append(tlb.access(page, now))
        elif op == "prefetch":
            tlb.prefetch(page, now)
        else:
            tlb.invalidate(page)
    return stalls


@pytest.mark.parametrize("entries,walk,latency", [
    (32, 0, 13), (4, 0, 100), (8, 50, 13), (1, 0, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iotlb_counts_equal_reference(seed, entries, walk, latency):
    ops = _stream(seed)
    jt = JIOTLB(JParams(entries=entries, walk_cycles=walk),
                mem_latency=latency)
    tt = IOTLB(IOTLBParams(entries=entries, walk_cycles=walk),
               mem_latency=latency)
    assert _replay(tt, ops) == _replay(jt, ops)
    assert tt.stats() == jt.stats()
    assert (tt.hits, tt.misses, tt.prefetches, tt.accesses) == \
        (jt.hits, jt.misses, jt.prefetches, jt.accesses)
    assert tt.hits > 0 and tt.misses > 0 and tt.prefetches > 0
    assert list(tt._entries.items()) == list(jt._entries.items())


def test_iotlb_params_equal_reference_and_validate():
    assert DEFAULT_WALK_CYCLES == 20
    for lat in (1, 13, 100):
        assert IOTLBParams().resolved_walk_cycles(lat) == \
            JParams().resolved_walk_cycles(lat) == 2 * lat + T.PIPE
        assert IOTLBParams(walk_cycles=7).resolved_walk_cycles(lat) == 7
    with pytest.raises(ValueError, match="entry"):
        IOTLBParams(entries=0)
    with pytest.raises(ValueError, match="walk_cycles"):
        IOTLBParams(walk_cycles=-1)
    assert remap_cycles(24, 28) == jremap(24, 28)


def _ours(mod, spec_mod, iotlb):
    return mod.SimConfig("ours", in_flight=4,
                         prefetch=spec_mod.FixedDepth(4), iotlb=iotlb)


@pytest.mark.parametrize("policy", ["fixed4", "fixed0", "adaptive"])
@pytest.mark.parametrize("latency", [1, 13, 100])
def test_simulate_with_iotlb_equals_reference(latency, policy):
    jpol, tpol = {
        "fixed4": (JS.FixedDepth(4), FixedDepth(4)),
        "fixed0": (JS.FixedDepth(0), FixedDepth(0)),
        "adaptive": (JS.AdaptiveDepth(), AdaptiveDepth()),
    }[policy]
    for entries in (4, 32):
        for hit in (0.5, 0.95, 1.0):
            want = J.simulate(_ours(J, JS, JParams(entries=entries,
                                                   prefetch=jpol)),
                              latency, 256, num_transfers=200, hit_rate=hit)
            got = T.simulate(_ours(T, TS, IOTLBParams(entries=entries,
                                                      prefetch=tpol)),
                             latency, 256, num_transfers=200, hit_rate=hit)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.tlb_hits + got.tlb_misses > 0


def test_iotlb_none_is_the_model_before_the_mmu():
    """With no IOTLB the port's result is the reference's without one, the
    TLB fields stay zero, and an explicit None changes nothing."""
    base = T.SimConfig("ours", in_flight=4, prefetch=TS.FixedDepth(4))
    jbase = J.SimConfig("ours", in_flight=4, prefetch=JS.FixedDepth(4))
    r0 = T.simulate(base, 13, 256, num_transfers=64)
    r1 = T.simulate(dataclasses.replace(base, iotlb=None), 13, 256,
                    num_transfers=64)
    assert dataclasses.asdict(r0) == dataclasses.asdict(r1) == \
        dataclasses.asdict(J.simulate(jbase, 13, 256, num_transfers=64))
    assert r1.tlb_hits == r1.tlb_misses == 0
    assert r1.walk_stall_cycles == 0 and r1.tlb_hit_rate == 0.0


def test_iotlb_chain_lookahead_prefetch_hides_walks():
    base = T.SimConfig("ours", in_flight=4, prefetch=TS.FixedDepth(4))
    pf = T.simulate(dataclasses.replace(base, iotlb=IOTLBParams()),
                    13, 256, num_transfers=200, hit_rate=0.95)
    demand = T.simulate(
        dataclasses.replace(base, iotlb=IOTLBParams(prefetch=FixedDepth(0))),
        13, 256, num_transfers=200, hit_rate=0.95)
    assert pf.tlb_hit_rate >= 0.9
    assert demand.tlb_hit_rate < pf.tlb_hit_rate
    assert pf.walk_stall_cycles < demand.walk_stall_cycles
    assert pf.cycles < demand.cycles


def test_mmu_cells_equal_reference():
    from repro.perf.mmu_cell import mmu_cell_entries as jentries
    from repro_torch.perf.mmu_cell import MMUCellSpec, mmu_cell_entries
    assert list(mmu_cell_entries(0, (1, 13, 100))) == \
        list(jentries(0, (1, 13, 100)))
    small = MMUCellSpec(num_transfers=64, defrag_pages=8)
    from repro.perf.mmu_cell import MMUCellSpec as JSpec
    assert list(mmu_cell_entries(3, (13,), small)) == list(jentries(
        3, (13,), JSpec(num_transfers=64, defrag_pages=8)))
