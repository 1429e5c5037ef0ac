"""Sharded DMA serving across a device mesh (DESIGN.md §6).

The paper's win is decoupling transfer *launch* from the processing units;
at production scale that decoupling must survive sharding. Following the
multi-frontend direction of iDMA (arXiv 2305.05240) and XDMA's
distributed layout-flexible data movement (arXiv 2508.08396), this module
instantiates one full :class:`repro_torch.runtime.DMARuntime` — submission
rings, serial data channels, coalescer, completion queue, control channel
— per mesh shard, and lowers every cross-shard page movement into §II-B
descriptor chains:

* **Page ownership** (:class:`PageOwnerMap`) — the global page space is
  statically partitioned across shards; a page's owner never changes, the
  page *contents* move.
* **Migration planner** (:meth:`ShardedDMARuntime.migrate_rows`) — page
  moves are split into shard-local chains (submitted straight to the
  owner's serial channel, where the runtime coalescer merges contiguous
  page runs) and cross-shard *hops*: an egress gather chain on the source
  shard into a staging buffer, the fabric transfer (``tensor.to(device)``
  when the shard has a mesh device of its own), and an ingress scatter
  chain on the destination shard. Every hop carries a per-hop completion
  control descriptor on the destination's control channel: the §II-D
  writeback is the only signal the planner trusts that a hop's bytes
  landed.
* **Sharded serve path** (:class:`ShardedServeEngine`) — requests are
  admitted to the shard that owns (the majority of) their KV pages;
  pages a request needs from other shards become migration chains into
  the owning shard before admission ("remote reads become migrations").

Shards are *logical*: with a :class:`repro_torch.distributed.shardlib.Mesh`
the per-shard pools are placed on the mesh's devices (1×N and N×1 meshes
are equivalent — the shard count is the device count), and without one
every shard's pools live on the runtime's one device (``cuda`` unless the
caller passes ``device="cpu"``) with identical semantics, so the perf
sweep's gated numbers are placement-independent and regenerate
bit-for-bit anywhere.

Pools are torch tensors that drains may update in place, where the JAX
package rebinds immutable arrays. Every pool a shard registers is
therefore a fresh tensor (``_pad`` concatenates), never a view of the
caller's array or of another pool, and each cross-shard hop stages its
pages in a buffer allocated for that hop alone and dropped when it
retires.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.chain import from_segments
from repro_torch.core.pageref import PageRef, as_pagerefs
from repro_torch.core.prefetch import estimate_hit_rate
from repro_torch.mmu import PageTable
from repro_torch.obs.counters import PerfCounters, namespaced
from repro_torch.obs.metrics import Histogram
from repro_torch.obs.trace import Tracer, monotonic
from repro_torch.runtime import ChannelConfig, DMARuntime, PerfProbe
from repro_torch.runtime.submit import (
    SubmitRequest,
    Ticket,
    reject_legacy_submit,
)

from . import shardlib
from .fabric import (
    COMPLETED,
    EGRESS,
    INGRESS,
    AsyncFabric,
    FabricTicket,
    RebalancePlanner,
)


def resolve_num_shards(mesh=None) -> int:
    """Shard count of a mesh: its total device count (shape-agnostic, so
    1×N and N×1 meshes shard identically)."""
    mesh = mesh if mesh is not None else shardlib.current_mesh()
    if mesh is None:
        return 1
    return int(np.prod(list(mesh.shape.values()), dtype=np.int64))


@dataclasses.dataclass(frozen=True)
class PageOwnerMap:
    """Static partition of a global page space across shards.

    Shard ``s`` owns the contiguous block of global pages
    ``[s * pages_per_shard, (s + 1) * pages_per_shard)``; a page's local
    row on its owner is its offset inside that block.
    """

    num_pages: int
    num_shards: int

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError("need >= 1 shard")
        if self.num_pages % self.num_shards:
            raise ValueError(
                f"{self.num_pages} pages do not partition evenly over "
                f"{self.num_shards} shards")

    @property
    def pages_per_shard(self) -> int:
        return self.num_pages // self.num_shards

    def owner(self, page: int) -> int:
        if not 0 <= page < self.num_pages:
            raise IndexError(f"page {page} outside [0, {self.num_pages})")
        return page // self.pages_per_shard

    def local_row(self, page: int) -> int:
        return page % self.pages_per_shard

    def shard_pages(self, shard: int) -> range:
        lo = shard * self.pages_per_shard
        return range(lo, lo + self.pages_per_shard)


@dataclasses.dataclass
class MigrationStats:
    """What one ``migrate_rows`` plan did, summed over pools and hops."""

    pages: int = 0              # page moves requested
    local_pages: int = 0        # moves with src and dst on one shard
    cross_pages: int = 0        # moves that crossed the fabric
    hops: int = 0               # (src_shard, dst_shard) fabric transfers
    chain_in: int = 0           # descriptors before the coalescer
    chain_out: int = 0          # descriptors after merge (real submissions)
    hop_completions: int = 0    # per-hop §II-D writebacks observed
    fabric_inflight_rounds: int = 0  # pump rounds with a hop on the wire
    fabric_hidden_rounds: int = 0    # ... during which a shard drained

    @property
    def merge_ratio(self) -> float:
        """chain_in / chain_out — the §II-C payoff of run-preserving
        migration plans (>1 means contiguous page runs were fused)."""
        return self.chain_in / max(self.chain_out, 1)

    @property
    def overlap_ratio(self) -> float:
        """Fraction of fabric in-flight rounds hidden behind local drain
        progress (async fabric only; 0.0 when nothing crossed the wire).

        Accounted globally by the pump loop — only the mesh-wide
        ``ShardedDMARuntime.migration`` aggregate carries these rounds;
        per-plan stats report their own hops/chains but leave the fabric
        round fields at zero (a round is not attributable to one plan)."""
        return self.fabric_hidden_rounds / max(self.fabric_inflight_rounds, 1)

    def merge(self, other: "MigrationStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


class ShardedDMARuntime:
    """One DMA runtime per mesh shard plus the cross-shard migration planner.

    Each shard owns ``data_channels`` serial-tier channels (the §II-B
    chain path, coalescer on) and one control-tier ``completion`` channel
    (serve-request markers and per-hop migration writebacks). Pools are
    registered *sharded*: a flat global row space split into per-shard
    slices, placed on the shard's mesh device when a mesh is present.
    """

    STAGE_POOL = "migrate.stage"

    def __init__(
        self,
        num_shards: Optional[int] = None,
        mesh=None,
        *,
        data_channels: int = 2,
        ring_capacity: int = 256,
        max_len: int = 1024,
        completion_ring: int = 256,
        arbitration: str = "round_robin",
        backpressure: str = "block",
        speculation=None,
        translation: bool = True,
        fabric: str = "async",
        fabric_latency: int = 1,
        fabric_page_beats: int = 1,
        device=None,
    ):
        if fabric not in ("async", "sync"):
            raise ValueError(f"fabric must be 'async' or 'sync', "
                             f"got {fabric!r}")
        explicit_mesh = mesh is not None
        mesh = mesh if explicit_mesh else shardlib.current_mesh()
        mesh_shards = resolve_num_shards(mesh)
        if num_shards is None:
            num_shards = mesh_shards
        if mesh is not None and num_shards != mesh_shards:
            if explicit_mesh:
                raise ValueError(
                    f"num_shards={num_shards} but the mesh has "
                    f"{mesh_shards} devices; drop one or make them agree")
            # An *ambient* mesh of the wrong size must not veto an
            # explicit shard count (e.g. the mesh-1 perf cell running
            # inside someone else's 8-device context): shards are
            # logical, so just run unplaced — no metric depends on it.
            mesh = None
        if num_shards < 1:
            raise ValueError("need >= 1 shard")
        self.num_shards = num_shards
        self.mesh = mesh
        self._devices = ([torch.device(d) for d in
                          np.asarray(mesh.devices, dtype=object).flat]
                         if mesh is not None else None)
        self.data_channels = data_channels
        self.shards: List[DMARuntime] = []
        for s in range(num_shards):
            cfgs = [ChannelConfig(name=f"dma{i}", tier="serial",
                                  ring_capacity=ring_capacity,
                                  max_len=max_len)
                    for i in range(data_channels)]
            cfgs.append(ChannelConfig(name="completion", tier="control",
                                      ring_capacity=completion_ring))
            # Per-shard translation caches: each shard lowers its own
            # migration-hop and data chains (counters aggregate in stats()).
            self.shards.append(DMARuntime(
                cfgs, arbitration=arbitration, backpressure=backpressure,
                speculation=speculation, translation=translation,
                device=(self._devices[s] if self._devices is not None
                        else device)))
        self.max_len = max_len
        self._sharded_pools: Dict[str, PageOwnerMap] = {}
        self._row_elems: Dict[str, int] = {}
        self._pool_elems: Dict[str, int] = {}   # logical per-shard elements
        self.migration = MigrationStats()
        self.tracer: Optional[Tracer] = None
        self._trace_args: Dict[str, object] = {}
        self._hop_seq = 0    # sampling key for hop spans (deterministic)
        # -- async fabric state (DESIGN.md §10) --
        self.fabric_mode = fabric
        self.fabric = (AsyncFabric(latency=fabric_latency,
                                   page_beats=fabric_page_beats)
                       if fabric == "async" else None)
        self._pending_hops: List[FabricTicket] = []
        # Elastic mesh membership: resize flips these, ownership does not
        # move — an inactive shard's pages are evacuated, not re-owned.
        self.active: List[bool] = [True] * num_shards

    # -- instrumentation -----------------------------------------------------
    def attach_probe(self, probe: Optional[PerfProbe]) -> None:
        """One probe observes every shard (channel names collide by design:
        the probe's per-channel counters aggregate the mesh)."""
        for rt in self.shards:
            rt.attach_probe(probe)

    def attach_tracer(self, tracer: Optional[Tracer]) -> None:
        """Attach (or with None, detach) a lifecycle span tracer.

        Every shard's runtime gets the same tracer under a ``shard{i}/``
        track prefix, so an exported timeline shows one track group per
        shard; migration hops additionally emit egress/fabric/ingress
        spans linked by Perfetto flow arrows (DESIGN.md §8).
        """
        self.tracer = tracer
        for s, rt in enumerate(self.shards):
            rt.attach_tracer(tracer, track_prefix=f"shard{s}/")

    @contextlib.contextmanager
    def trace_context(self, **args):
        """Parent subsequent hop spans to a logical originator.

        The serve router wraps remote-page pull-ins in
        ``trace_context(uid=...)`` so every egress/fabric/ingress span of
        the resulting hops carries the originating request id.
        """
        prev = self._trace_args
        self._trace_args = {**prev, **args}
        try:
            yield
        finally:
            self._trace_args = prev

    # -- pools ---------------------------------------------------------------
    def _place(self, shard: int, array: torch.Tensor) -> torch.Tensor:
        """``array`` on the shard's device: the identity when it is there
        already (every shard of an unmeshed runtime), else a
        device-to-device copy — the fabric hop of a staging buffer."""
        return array.to(self.shards[shard].device)

    def _pad(self, array: torch.Tensor) -> torch.Tensor:
        """Append ``max_len`` of tail padding to a flat pool.

        ``execute_serial`` copies through static ``max_len``-sized masked
        windows whose start offsets XLA *clamps* into bounds — a window
        starting within ``max_len`` of the pool end would silently land at
        the clamped offset. Tail padding guarantees every in-bounds
        descriptor's window fits, so no start is ever clamped. The result
        is a fresh tensor, whatever ``array`` aliases.
        """
        return torch.cat([array, array.new_zeros(self.max_len)])

    def _stage_buffer(self, shard: int, pool: str, n_rows: int,
                      row_elems: int) -> torch.Tensor:
        """A zeroed, padded send window of ``n_rows`` rows of ``pool``
        on ``shard``'s device."""
        like = self.shards[shard].pool(pool)
        return self._pad(like.new_zeros(n_rows * row_elems))

    def register_sharded_pool(self, name: str, array,
                              owner: PageOwnerMap, row_elems: int) -> None:
        """Split a flat global row pool into per-shard slices.

        ``array`` (a tensor or a numpy array) has ``owner.num_pages *
        row_elems`` elements; shard ``s`` receives a padded copy of the
        slice covering its pages on its own device, so no later write to
        ``array`` (or to another pool) reaches the shard's pool.
        """
        if name == self.STAGE_POOL or \
                name.startswith(self.STAGE_POOL + "."):
            raise ValueError(
                f"pool name {name!r} is reserved for the migration "
                "planner's staging buffers")
        array = torch.as_tensor(array)
        if array.ndim != 1 or array.shape[0] != owner.num_pages * row_elems:
            raise ValueError(
                f"pool {name!r}: expected flat "
                f"({owner.num_pages * row_elems},) array, "
                f"got shape {array.shape}")
        if owner.num_shards != self.num_shards:
            raise ValueError("owner map shard count mismatch")
        per = owner.pages_per_shard * row_elems
        for s, rt in enumerate(self.shards):
            rt.register_pool(name, self._pad(
                array[s * per:(s + 1) * per].to(rt.device)))
        self._sharded_pools[name] = owner
        self._row_elems[name] = row_elems
        self._pool_elems[name] = per

    def pool_shard(self, name: str, shard: int) -> torch.Tensor:
        """A shard's logical pool slice (padding stripped): a view of the
        live pool, which later drains may write."""
        return self.shards[shard].pool(name)[:self._pool_elems[name]]

    def gather_pool(self, name: str) -> np.ndarray:
        """The global flat pool, reassembled host-side in page order."""
        return np.concatenate([self.pool_shard(name, s).cpu().numpy()
                               for s in range(self.num_shards)])

    # -- migration planner ---------------------------------------------------
    def migrate_rows(
        self,
        pool_names: Sequence[str],
        src_pages: Sequence[int],
        dst_pages: Sequence[int],
        *,
        drain: bool = True,
        priority: int = 0,
    ) -> MigrationStats:
        """Lower page moves into descriptor chains across the mesh.

        All named pools move in lockstep under one plan (the paged-KV K/V
        pair). Local moves go straight onto the owner shard's serial
        channels; cross-shard moves become per-(src, dst)-shard hops:
        egress gather chain -> fabric -> ingress scatter chain, with the
        hop's completion control descriptor written back (§II-D) on the
        destination shard only after the ingress chain drained.

        Under the async fabric (the default), hops are non-blocking
        :class:`repro_torch.distributed.fabric.FabricTicket` objects: the
        local-gather half issues immediately and the remote-scatter half
        completes when the fabric delivers, with shard drains overlapping
        in-flight hops via :meth:`pump`. ``drain=True`` pumps the plan to
        completion before returning; ``drain=False`` leaves the tickets
        outstanding for the caller to :meth:`pump` (hop_completions then
        lands on both the returned stats and the mesh aggregate as hops
        retire). ``priority`` rides the channels' weighted arbitration —
        the rebalancer submits at 0 so it never preempts serve traffic.
        The synchronous fabric (``fabric="sync"``) ignores ``priority``
        and executes hops exactly as PR 8 did.
        """
        if len(src_pages) != len(dst_pages):
            raise ValueError("src/dst page lists must pair up")
        stats = MigrationStats()
        if not src_pages:
            return stats
        if not pool_names:
            raise ValueError("need at least one pool to migrate")
        owner = self._sharded_pools[pool_names[0]]
        for name in pool_names:
            if self._sharded_pools.get(name) != owner:
                raise ValueError(
                    f"pool {name!r} is not sharded under the same owner map")

        src = np.asarray(src_pages, np.int64)
        dst = np.asarray(dst_pages, np.int64)
        # Hops execute grouped by shard pair, not in plan order, and even
        # one in-order chain clobbers serially — a destination that is
        # also a source (or a doubly-written destination) is ambiguous.
        # Every real caller (defrag, remote-read pull-in) moves onto free
        # pages, so reject overlap loudly instead of corrupting quietly.
        if len(set(dst.tolist())) != len(dst):
            raise ValueError("duplicate destination pages in migration plan")
        overlap = set(src.tolist()) & set(dst.tolist())
        if overlap:
            raise ValueError(
                f"migration plan reads and writes pages {sorted(overlap)}; "
                "stage through free pages instead")
        stats.pages = len(src)
        s_owner = src // owner.pages_per_shard
        d_owner = dst // owner.pages_per_shard
        src_local = src % owner.pages_per_shard
        dst_local = dst % owner.pages_per_shard

        # Group moves by (src_shard, dst_shard), preserving plan order so
        # contiguous page runs survive into the chains the coalescer sees.
        groups: Dict[Tuple[int, int], List[int]] = {}
        for k in range(len(src)):
            groups.setdefault((int(s_owner[k]), int(d_owner[k])),
                              []).append(k)

        sync = self.fabric_mode == "sync"
        for (ss, ds), idx in sorted(groups.items()):
            rows_s = src_local[idx]
            rows_d = dst_local[idx]
            if ss == ds:
                stats.local_pages += len(idx)
                if sync:
                    self._submit_local(pool_names, ss, rows_s, rows_d,
                                       stats)
                else:
                    self._submit_local_async(pool_names, ss, rows_s,
                                             rows_d, stats, priority)
            else:
                stats.cross_pages += len(idx)
                stats.hops += 1
                if sync:
                    self._submit_hop(pool_names, ss, ds, rows_s, rows_d,
                                     stats)
                else:
                    self._begin_hop(pool_names, ss, ds, rows_s, rows_d,
                                    stats, priority)
        if not sync and drain:
            self.pump_until_idle()
        if drain:
            self.drain_until_idle()
        self.migration.merge(stats)
        if not sync:
            # Hops left outstanding (drain=False) retire later inside
            # pump(); their writeback counts must land on the mesh
            # aggregate too, so mark this plan's stats as already merged.
            for t in self._pending_hops:
                if t.stats is stats:
                    t.merged = True
        return stats

    def _chain(self, rows_s: np.ndarray, rows_d: np.ndarray,
               row_elems: int):
        return from_segments(rows_s * row_elems, rows_d * row_elems,
                             np.full(len(rows_s), row_elems, np.int64))

    def _submit_local(self, pool_names, shard, rows_s, rows_d, stats):
        rt = self.shards[shard]
        for name in pool_names:
            d = self._chain(rows_s, rows_d, self._row_elems[name])
            res = rt.submit(SubmitRequest(
                chain=d, src_pool=name, dst_pool=name, tier="serial"))
            if res.coalesce is not None:
                stats.chain_in += res.coalesce.n_in
                stats.chain_out += res.coalesce.n_out
        rt.drain_until_idle()

    def _submit_hop(self, pool_names, src_shard, dst_shard,
                    rows_s, rows_d, stats):
        src_rt = self.shards[src_shard]
        dst_rt = self.shards[dst_shard]
        n = len(rows_s)
        ctrl = dst_rt.submit_control(payload=src_shard,
                                     channel="completion")
        # One flow arrow per hop (egress -> fabric -> ingress), sampled on
        # the process-deterministic hop ordinal; the spans carry whatever
        # the active trace_context says originated this hop (request uid).
        tr = self.tracer
        self._hop_seq += 1
        rec = tr is not None and tr.sampled(("hop", self._hop_seq))
        fid = tr.next_flow_id() if rec else 0
        hop_args = dict(self._trace_args, src_shard=src_shard,
                        dst_shard=dst_shard, pages=n) if rec else {}
        first_pool = pool_names[0]
        for name in pool_names:
            row_elems = self._row_elems[name]
            stage_rows = np.arange(n, dtype=np.int64)
            # Egress: gather the moving pages into a dense staging buffer
            # on the source shard (the fabric's send window).
            t0 = monotonic() if rec else 0.0
            src_rt.register_pool(
                self.STAGE_POOL,
                self._stage_buffer(src_shard, name, n, row_elems))
            d_out = self._chain(rows_s, stage_rows, row_elems)
            res = src_rt.submit(SubmitRequest(
                chain=d_out, src_pool=name, dst_pool=self.STAGE_POOL,
                tier="serial"))
            if res.coalesce is not None:
                stats.chain_in += res.coalesce.n_in
                stats.chain_out += res.coalesce.n_out
            src_rt.drain_until_idle()
            t1 = monotonic() if rec else 0.0
            if rec:
                track = f"shard{src_shard}/migrate"
                tr.complete("migrate.egress", track, t0 * 1e6,
                            (t1 - t0) * 1e6, pool=name, **hop_args)
                if name == first_pool:
                    # Flow start binds to the egress slice just emitted.
                    tr.flow_start("hop", track, fid, ts=t1 * 1e6 - 1e-3)
            # Fabric transfer: the staging buffer crosses to the
            # destination shard's device.
            stage = self._place(dst_shard, src_rt.pool(self.STAGE_POOL))
            dst_rt.register_pool(self.STAGE_POOL, stage)
            t2 = monotonic() if rec else 0.0
            if rec:
                tr.complete("migrate.fabric", "fabric", t1 * 1e6,
                            (t2 - t1) * 1e6, pool=name, **hop_args)
                if name == first_pool:
                    tr.flow_step("hop", "fabric", fid, ts=t2 * 1e6 - 1e-3)
            # Ingress: scatter staging rows onto the destination pages.
            d_in = self._chain(stage_rows, rows_d, row_elems)
            res = dst_rt.submit(SubmitRequest(
                chain=d_in, src_pool=self.STAGE_POOL, dst_pool=name,
                tier="serial"))
            if res.coalesce is not None:
                stats.chain_in += res.coalesce.n_in
                stats.chain_out += res.coalesce.n_out
            dst_rt.drain_until_idle()
            if rec:
                t3 = monotonic()
                track = f"shard{dst_shard}/migrate"
                tr.complete("migrate.ingress", track, t2 * 1e6,
                            (t3 - t2) * 1e6, pool=name, **hop_args)
                if name == first_pool:
                    tr.flow_end("hop", track, fid, ts=t3 * 1e6 - 1e-3)
        # Per-hop completion: only after every pool's ingress chain
        # drained does the hop's control descriptor get its §II-D
        # writeback. It is observed via the non-destructive ring table
        # scan (the serve scheduler's poll): draining the shared
        # completion queue here would steal other owners' events — a
        # ServeEngine on this shard polls the same queue.
        dst_rt.complete(ctrl.tickets[-1])
        ring = dst_rt.channels["completion"].ring
        stats.hop_completions += int(
            ctrl.tickets[-1] in ring.live_done_tickets())
        # The staging buffer is planner-internal scratch: drop it so pool
        # enumerations (stats, gather, serialization) never see hop state.
        src_rt.pools.pop(self.STAGE_POOL, None)
        dst_rt.pools.pop(self.STAGE_POOL, None)

    # -- async fabric (DESIGN.md §10) ----------------------------------------
    def _stage_name(self, hop_id: int, pool: str) -> str:
        """Per-(hop, pool) staging buffer name: concurrent in-flight hops
        on one shard must not clobber each other's send windows."""
        return f"{self.STAGE_POOL}.{hop_id}.{pool}"

    def _submit_local_async(self, pool_names, shard, rows_s, rows_d,
                            stats, priority):
        # Same chains as the sync path, but no drain here: local batches
        # drain inside pump() rounds, overlapping with in-flight hops.
        rt = self.shards[shard]
        for name in pool_names:
            d = self._chain(rows_s, rows_d, self._row_elems[name])
            res = rt.submit(SubmitRequest(
                chain=d, src_pool=name, dst_pool=name, tier="serial",
                priority=priority))
            if res.coalesce is not None:
                stats.chain_in += res.coalesce.n_in
                stats.chain_out += res.coalesce.n_out

    def _begin_hop(self, pool_names, src_shard, dst_shard, rows_s, rows_d,
                   stats, priority) -> FabricTicket:
        """Issue the local-gather half of a hop and ticket the rest.

        The egress gather chains go onto the source shard's serial
        channels *without* draining; the control descriptor is posted on
        the destination up front (its §II-D writeback still only fires
        at :meth:`_finish_hop`, after every ingress chain drained)."""
        src_rt = self.shards[src_shard]
        dst_rt = self.shards[dst_shard]
        n = len(rows_s)
        ctrl = dst_rt.submit_control(payload=src_shard,
                                     channel="completion")
        tr = self.tracer
        self._hop_seq += 1
        rec = tr is not None and tr.sampled(("hop", self._hop_seq))
        t = FabricTicket(
            hop_id=self._hop_seq, src_shard=src_shard, dst_shard=dst_shard,
            pages=n, pool_names=tuple(pool_names),
            rows_s=np.asarray(rows_s, np.int64),
            rows_d=np.asarray(rows_d, np.int64),
            ctrl_ticket=ctrl.tickets[-1], stats=stats, priority=priority,
            issued_round=self.fabric.now, rec=rec,
            flow_id=tr.next_flow_id() if rec else 0,
            trace_args=(dict(self._trace_args, src_shard=src_shard,
                             dst_shard=dst_shard, pages=n) if rec else {}),
            t0=monotonic() if rec else 0.0)
        stage_rows = np.arange(n, dtype=np.int64)
        for name in pool_names:
            row_elems = self._row_elems[name]
            stage = self._stage_name(t.hop_id, name)
            src_rt.register_pool(stage, self._stage_buffer(
                src_shard, name, n, row_elems))
            d_out = self._chain(rows_s, stage_rows, row_elems)
            res = src_rt.submit(SubmitRequest(
                chain=d_out, src_pool=name, dst_pool=stage, tier="serial",
                priority=priority))
            if res.coalesce is not None:
                stats.chain_in += res.coalesce.n_in
                stats.chain_out += res.coalesce.n_out
            t.egress.append((name, res.channel, frozenset(res.tickets)))
        self._pending_hops.append(t)
        return t

    @staticmethod
    def _chains_pending(rt: DMARuntime, entries) -> bool:
        """Whether any of a hop's submitted chains still await drain.

        A data chain is done exactly when none of its tickets sit in a
        pending ring batch (or the spill queue) any more — ``drain_one``
        marks the slots done and retires them in the same step, so batch
        membership is the drain-state signal. The completion queue is
        deliberately *not* polled: its events belong to the serve
        scheduler (see the sync hop's writeback comment)."""
        for _, channel, tset in entries:
            for b in rt.channels[channel].pending:
                if tset.intersection(b.tickets):
                    return True
        for sp in rt._spill:
            for _, _, tset in entries:
                if tset.intersection(sp.tickets):
                    return True
        return False

    def _hop_stat(self, t: FabricTicket, **deltas) -> None:
        """Bump a hop's plan stats; mirror onto the mesh aggregate when
        the plan was already merged (drain=False plans retire late)."""
        for k, v in deltas.items():
            setattr(t.stats, k, getattr(t.stats, k) + v)
            if t.merged:
                setattr(self.migration, k, getattr(self.migration, k) + v)

    def _send_hop(self, t: FabricTicket) -> None:
        """Egress drained: capture the staging buffers onto the
        destination device and put the payload on the fabric link."""
        src_rt = self.shards[t.src_shard]
        tr = self.tracer
        if t.rec:
            t.t1 = monotonic()
            track = f"shard{t.src_shard}/migrate"
            tr.complete("migrate.egress", track, t.t0 * 1e6,
                        (t.t1 - t.t0) * 1e6, **t.trace_args)
            tr.flow_start("hop", track, t.flow_id, ts=t.t1 * 1e6 - 1e-3)
        for name in t.pool_names:
            stage = self._stage_name(t.hop_id, name)
            t.staged[name] = self._place(t.dst_shard, src_rt.pool(stage))
            src_rt.pools.pop(stage, None)
        self.fabric.send(t)
        if t.rec:
            ln = self.fabric.link(t.src_shard, t.dst_shard)
            tr.counter(f"fabric.link{t.src_shard}-{t.dst_shard}", "fabric",
                       occupancy_rounds=max(0, ln.busy_until -
                                            self.fabric.now),
                       pages_in_flight=t.pages)

    def _submit_ingress(self, t: FabricTicket) -> None:
        """Fabric delivered: issue the remote-scatter half on the
        destination shard (completes via the §II-D writeback)."""
        dst_rt = self.shards[t.dst_shard]
        tr = self.tracer
        if t.rec:
            t.t2 = monotonic()
            tr.complete("migrate.fabric", "fabric", t.t1 * 1e6,
                        (t.t2 - t.t1) * 1e6, sent_round=t.sent_round,
                        deliver_round=t.deliver_round, **t.trace_args)
            tr.flow_step("hop", "fabric", t.flow_id, ts=t.t2 * 1e6 - 1e-3)
            ln = self.fabric.link(t.src_shard, t.dst_shard)
            tr.counter(f"fabric.link{t.src_shard}-{t.dst_shard}", "fabric",
                       occupancy_rounds=max(0, ln.busy_until -
                                            self.fabric.now),
                       pages_in_flight=0)
        stage_rows = np.arange(t.pages, dtype=np.int64)
        for name in t.pool_names:
            stage = self._stage_name(t.hop_id, name)
            dst_rt.register_pool(stage, t.staged.pop(name))
            d_in = self._chain(stage_rows, t.rows_d,
                               self._row_elems[name])
            res = dst_rt.submit(SubmitRequest(
                chain=d_in, src_pool=stage, dst_pool=name, tier="serial",
                priority=t.priority))
            if res.coalesce is not None:
                self._hop_stat(t, chain_in=res.coalesce.n_in,
                               chain_out=res.coalesce.n_out)
            t.ingress.append((name, res.channel, frozenset(res.tickets)))

    def _finish_hop(self, t: FabricTicket) -> None:
        """Ingress drained: observe the hop's §II-D writeback and drop
        the staging pools (non-destructive ring scan, never a queue
        poll — the completion queue belongs to the serve scheduler)."""
        dst_rt = self.shards[t.dst_shard]
        dst_rt.complete(t.ctrl_ticket)
        ring = dst_rt.channels["completion"].ring
        self._hop_stat(t, hop_completions=int(
            t.ctrl_ticket in ring.live_done_tickets()))
        for name in t.pool_names:
            dst_rt.pools.pop(self._stage_name(t.hop_id, name), None)
        t.state = COMPLETED
        t.completed_round = self.fabric.now
        if t.rec:
            t3 = monotonic()
            track = f"shard{t.dst_shard}/migrate"
            self.tracer.complete("migrate.ingress", track, t.t2 * 1e6,
                                 (t3 - t.t2) * 1e6, **t.trace_args)
            self.tracer.flow_end("hop", track, t.flow_id,
                                 ts=t3 * 1e6 - 1e-3)

    def _pump_round(self) -> int:
        """One fabric round: drain every active shard once, tick the
        clock, then move tickets through their lifecycle edges."""
        fab = self.fabric
        progress = 0
        for s, rt in enumerate(self.shards):
            if self.active[s]:
                progress += rt.drain_all()
        fab.advance()
        # Higher-priority tickets claim link slots first each round, so a
        # background handoff (priority 0) queued behind foreground serve
        # migration (priority 1) cannot capture a link ahead of it.
        ready = [t for t in self._pending_hops
                 if t.state == EGRESS and not self._chains_pending(
                     self.shards[t.src_shard], t.egress)]
        for t in sorted(ready, key=lambda t: (-t.priority, t.hop_id)):
            self._send_hop(t)
        for t in fab.deliveries():
            self._submit_ingress(t)
        finished = False
        for t in self._pending_hops:
            if t.state == INGRESS and not self._chains_pending(
                    self.shards[t.dst_shard], t.ingress):
                self._finish_hop(t)
                finished = True
        if finished:
            self._pending_hops = [t for t in self._pending_hops
                                  if t.state != COMPLETED]
        # Overlap accounting: a round counts as in-flight when a payload
        # is on the wire, and as hidden when local drains made progress
        # under it. Global only — rounds are mesh-wide, not per-plan.
        if fab.in_flight:
            self.migration.fabric_inflight_rounds += 1
            if progress:
                self.migration.fabric_hidden_rounds += 1
            for t in fab.in_flight:
                t.inflight_rounds += 1
                if progress:
                    t.hidden_rounds += 1
        return progress

    def fabric_outstanding(self) -> int:
        """Hops ticketed but not yet completed (async fabric)."""
        return len(self._pending_hops)

    def plan_outstanding(self, stats: MigrationStats) -> int:
        """Hops of one ``migrate_rows`` plan still on the fabric — lets a
        caller pump a foreground plan to completion while background
        traffic (rebalance, resize handoff) keeps flowing."""
        return sum(1 for t in self._pending_hops if t.stats is stats)

    def pump(self, rounds: int = 1) -> int:
        """Advance the async fabric by up to ``rounds`` rounds; returns
        batches drained. Stops early once no hop is outstanding."""
        if self.fabric_mode != "async":
            raise RuntimeError("pump() requires fabric='async'")
        drained = 0
        for _ in range(rounds):
            if not self._pending_hops:
                break
            drained += self._pump_round()
        return drained

    def pump_until_idle(self, max_rounds: int = 65536) -> None:
        """Run the pump until every outstanding hop completed."""
        if self.fabric_mode != "async":
            return
        for _ in range(max_rounds):
            if not self._pending_hops:
                return
            self._pump_round()
        raise RuntimeError(
            f"async fabric did not quiesce in {max_rounds} rounds "
            f"({len(self._pending_hops)} hops outstanding)")

    # -- elastic mesh membership ---------------------------------------------
    def set_active(self, shard: int, active: bool = True) -> None:
        """Flip a shard's mesh membership (resize). Ownership is static;
        an inactive shard's pages must have been evacuated first
        (``ShardedKVPool.evacuate`` / ``fault.ungraceful_resize``)."""
        self.active[shard] = bool(active)

    def active_shards(self) -> List[int]:
        return [s for s in range(self.num_shards) if self.active[s]]

    # -- drain / stats -------------------------------------------------------
    def drain_all(self) -> int:
        return sum(rt.drain_all()
                   for s, rt in enumerate(self.shards) if self.active[s])

    def drain_until_idle(self, max_rounds: int = 1024) -> None:
        if self._pending_hops:
            self.pump_until_idle()
        for s, rt in enumerate(self.shards):
            if self.active[s]:
                rt.drain_until_idle(max_rounds)

    def _translation_stats_raw(self) -> Dict[str, object]:
        """Bare-key mesh aggregate (summed over shards' raw blocks)."""
        from repro_torch.runtime.lowering import aggregate_stats
        return aggregate_stats(
            [rt._translation_stats_raw() for rt in self.shards])

    def translation_stats(self) -> PerfCounters:
        """Mesh-wide translation-cache counters (``translation.*`` keys)."""
        return namespaced(self._translation_stats_raw(), "translation")

    def stats(self) -> Dict[str, object]:
        out = {
            "num_shards": self.num_shards,
            "active_shards": self.active_shards(),
            "migration": dataclasses.asdict(self.migration),
            "migration_chain_merge_ratio": self.migration.merge_ratio,
            "migration_overlap_ratio": self.migration.overlap_ratio,
            "translation_cache": self.translation_stats(),
            "shards": [rt.stats() for rt in self.shards],
        }
        if self.fabric is not None:
            out["fabric"] = {
                "rounds": self.fabric.now,
                "outstanding_hops": len(self._pending_hops),
                "links": self.fabric.link_stats(),
            }
        return out


class ShardedKVPool:
    """Paged K/V pool partitioned across a sharded runtime's shards.

    Flat element-space pools (one K, one V) so migration chains run on the
    serial tier and the runtime coalescer genuinely merges contiguous page
    runs — the source of ``migration_chain_merge_ratio``. Page allocation
    is shard-aware: :meth:`alloc_on` hands out pages *owned by* a given
    shard, which is how the serve router keeps a request's pages local.

    Virtual addressing (DESIGN.md §11): callers hold :class:`PageRef`
    handles naming *virtual* pages; a :class:`repro_torch.mmu.PageTable` maps
    them to (shard, physical slot). Two consequences:

    * ``defragment(mode="remap")`` renumbers live pages onto dense
      virtual ids without moving a byte (the §II-C speculator sees a
      sequential virtual chain);
    * :meth:`flip_ownership` moves a page's *owner* immediately and
      leaves the contents behind — the first touch (:meth:`ensure_resident`,
      called by every contents accessor) pulls them lazily through the
      normal migration path. Static ``owner`` still partitions *slots*;
      the table partitions *pages*.
    """

    POOL_K = "kv.k"
    POOL_V = "kv.v"

    def __init__(self, runtime: ShardedDMARuntime, *, num_pages: int,
                 page: int, kv_heads: int, head_dim: int,
                 dtype=torch.float32):
        self.rt = runtime
        self.page, self.kv_heads, self.head_dim = page, kv_heads, head_dim
        self.row_elems = page * kv_heads * head_dim
        self.owner = PageOwnerMap(num_pages, runtime.num_shards)
        # One zero array for K and V alike: register_sharded_pool copies
        # it per shard, so the two pools never share storage.
        flat = torch.zeros(num_pages * self.row_elems, dtype=dtype,
                           device=runtime.shards[0].device)
        runtime.register_sharded_pool(self.POOL_K, flat, self.owner,
                                      self.row_elems)
        runtime.register_sharded_pool(self.POOL_V, flat, self.owner,
                                      self.row_elems)
        self._free: List[List[int]] = [
            sorted(self.owner.shard_pages(s))
            for s in range(runtime.num_shards)]
        # Virtual layer: vpage -> (shard, slot), plus which vids are
        # handed out. Identity until the first remap/flip, so legacy
        # int-addressed flows are bit-for-bit unchanged.
        self.table = PageTable(num_pages, runtime.num_shards)
        self._vused = np.zeros(num_pages, bool)
        self.first_touch_pulls = 0

    # -- allocation ----------------------------------------------------------
    def free_pages_on(self, shard: int) -> int:
        return len(self._free[shard])

    def refs(self, pages: Sequence[int]) -> List[PageRef]:
        """Mint :class:`PageRef` handles for virtual ids (the blessed
        conversion for internal code that computes ids numerically —
        bare ints through the public APIs are deprecated)."""
        return [PageRef(int(p), self.table.page_generation(int(p)))
                for p in pages]

    def owner_of(self, page) -> int:
        """Current owning shard of a virtual page (page-table truth —
        unlike ``owner.owner``, this follows :meth:`flip_ownership`)."""
        return self.table.shard_of(int(page))

    def _claim_vid(self, phys: int) -> PageRef:
        """Claim a virtual id for physical slot ``phys``: identity when
        the identity vid is free, else the lowest unused vid (remapped)."""
        shard = self.owner.owner(phys)
        vid = phys if not self._vused[phys] else int(
            np.flatnonzero(~self._vused)[0])
        self._vused[vid] = True
        if self.table.map(vid) != (shard, phys):
            self.table.remap(vid, shard, phys)
        return PageRef(vid, self.table.page_generation(vid))

    def alloc_on(self, shard: int, n: int) -> List[PageRef]:
        """Lowest-id free pages owned by ``shard`` (sequential preference:
        consecutive ids keep the §II-C speculator hitting)."""
        if not self.rt.active[shard]:
            raise RuntimeError(
                f"shard {shard} left the mesh; its pages are evacuated")
        free = self._free[shard]
        if n > len(free):
            raise RuntimeError(
                f"shard {shard}: need {n} pages, have {len(free)}")
        phys, self._free[shard] = free[:n], free[n:]
        return [self._claim_vid(p) for p in phys]

    def release(self, pages: Sequence[int]) -> None:
        refs = as_pagerefs(pages, api="ShardedKVPool.release")
        touched = set()
        for r in refs:
            v = int(r)
            s, slot = self.table.home_of(v)
            if self.table.is_pending(v):
                # Freeing an unpulled page drops the flip: the contents'
                # home slot is what actually returns to a free list.
                self.table.remap(v, s, slot)
            self._free[s].append(int(slot))
            self._vused[v] = False
            touched.add(s)
        for s in touched:
            self._free[s].sort()

    # -- translation / residency ---------------------------------------------
    def _locate(self, vpage: int) -> Tuple[int, int]:
        """(shard, slot) for a *resident* virtual page."""
        self.ensure_resident([vpage])
        return self.table.map(int(vpage))

    def ensure_resident(self, pages: Sequence[int], *,
                        priority: int = 0) -> int:
        """First-touch pull: materialize any ownership-flipped pages on
        their (new) owner through the normal migration path, then free
        the vacated home slots. Returns the number of pages pulled.

        This is the lazy half of ownership-first migration: a flip is a
        table write; the bytes only move when someone touches the page.
        Each pull is a single-page migration, so the first-touch cost is
        bounded by one page's hop latency — not the full batch.
        """
        pending = list(dict.fromkeys(
            int(p) for p in pages if self.table.is_pending(int(p))))
        if not pending:
            return 0
        moves = []
        for v in pending:
            hs, hslot = self.table.home_of(v)
            dshard = self.table.shard_of(v)
            free = self._free[dshard]
            if not free:
                raise RuntimeError(
                    f"shard {dshard}: no free slot to pull vpage {v} into")
            moves.append((v, hs, hslot, free.pop(0)))
        self.rt.migrate_rows(
            (self.POOL_K, self.POOL_V),
            [m[2] for m in moves], [m[3] for m in moves],
            priority=priority)
        for v, hs, hslot, slot in moves:
            self.table.complete_pull(v, slot)
            self._free[hs].append(hslot)
        for hs in {m[1] for m in moves}:
            self._free[hs].sort()
        self.first_touch_pulls += len(moves)
        return len(moves)

    def flip_ownership(self, pages: Sequence[int],
                       shard: int) -> List[PageRef]:
        """Ownership-first migration: the pages belong to ``shard`` *now*
        (routing, admission, and ``owner_of`` all see the flip
        immediately); their contents stay put until first touch. Returns
        refreshed refs (the flip bumps each page's generation)."""
        if not self.rt.active[shard]:
            raise RuntimeError(f"shard {shard} is not in the mesh")
        refs = as_pagerefs(pages, api="ShardedKVPool.flip_ownership")
        for r in refs:
            v = int(r)
            if self.table.shard_of(v) != int(shard):
                self.table.flip_owner(v, int(shard))
        return self.refs(refs)

    # -- contents (host-side oracle / writers) -------------------------------
    def write_page(self, page: int, k_row: np.ndarray,
                   v_row: np.ndarray) -> None:
        """Write one page's K and V rows, in place on its owner's pools."""
        (ref,) = as_pagerefs([page], api="ShardedKVPool.write_page")
        s, slot = self._locate(int(ref))
        lo = self.owner.local_row(slot) * self.row_elems
        rt = self.rt.shards[s]
        for name, row in ((self.POOL_K, k_row), (self.POOL_V, v_row)):
            arr = rt.pool(name)
            arr[lo:lo + self.row_elems] = torch.as_tensor(
                np.asarray(row), dtype=arr.dtype).reshape(-1).to(arr.device)

    def page_rows(self, pages: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """(K, V) rows for ``pages``, gathered host-side (test oracle)."""
        refs = as_pagerefs(pages, api="ShardedKVPool.page_rows")
        self.ensure_resident(refs)
        ks, vs = [], []
        for p in refs:
            s, slot = self.table.map(int(p))
            lo = self.owner.local_row(slot) * self.row_elems
            ks.append(self.rt.pool_shard(
                self.POOL_K, s)[lo:lo + self.row_elems].cpu().numpy())
            vs.append(self.rt.pool_shard(
                self.POOL_V, s)[lo:lo + self.row_elems].cpu().numpy())
        return (np.stack(ks) if ks else np.zeros((0, self.row_elems)),
                np.stack(vs) if vs else np.zeros((0, self.row_elems)))

    # -- runtime-mediated movement (DESIGN.md §6) ----------------------------
    def move_pages(self, src_pages: Sequence[int],
                   dst_pages: Sequence[int], *,
                   priority: int = 0,
                   drain: bool = True) -> MigrationStats:
        """Relocate page *contents* between virtual pages through the
        sharded runtime: local moves stay on the owner's channels,
        cross-owner moves become hops. Pages are addressed physically
        via the page table (pending pages are pulled resident first)."""
        src = as_pagerefs(src_pages, api="ShardedKVPool.move_pages")
        dst = as_pagerefs(dst_pages, api="ShardedKVPool.move_pages")
        self.ensure_resident(list(src) + list(dst), priority=priority)
        return self.rt.migrate_rows(
            (self.POOL_K, self.POOL_V),
            [self.table.slot_of(int(p)) for p in src],
            [self.table.slot_of(int(p)) for p in dst],
            priority=priority, drain=drain)

    # -- elastic mesh resize (DESIGN.md §10) ---------------------------------
    def evacuate(self, shard: int, *, planner=None, priority: int = 0,
                 exclude: Sequence[int] = ()) -> Dict[int, int]:
        """Graceful leave: hand the shard's live pages to survivors.

        The handoff lowers through :meth:`RebalancePlanner.placement`
        (free-capacity-weighted spread over the surviving shards) and
        rides the normal migration path at the given priority; the shard
        then goes inactive and its free list empties. Returns the
        ``{old_page: new_page}`` remap — the caller owns rewriting any
        references (serve request page lists) to the vacated pages.
        """
        srt = self.rt
        survivors = [s for s in srt.active_shards() if s != shard]
        if not survivors:
            raise RuntimeError("cannot evacuate the last active shard")
        banned = set(int(p) for p in exclude)
        live = sorted(set(self.owner.shard_pages(shard))
                      - set(self._free[shard]) - banned)
        if planner is None:
            planner = RebalancePlanner(srt.num_shards)
        new = planner.placement(self, live, survivors)
        if live:
            srt.migrate_rows((self.POOL_K, self.POOL_V), live, new,
                             priority=priority)
            # The page table follows the physical relocation, so every
            # PageRef naming an evacuated slot stays valid across the
            # resize (pending pages' pull homes follow too).
            self.table.rehome_slots(
                {o: (self.owner.owner(nw), nw)
                 for o, nw in zip(live, new)})
        self._free[shard] = []
        srt.set_active(shard, False)
        return dict(zip(live, new))

    def readmit(self, shard: int) -> None:
        """Rejoin after a leave: the shard comes back empty — evacuation
        moved every live page off, so its whole owned block is free."""
        self.rt.set_active(shard, True)
        self._free[shard] = sorted(self.owner.shard_pages(shard))

    def defragment(self, pages: Sequence[int], *,
                   mode: str = "remap") -> Tuple[List[PageRef],
                                                 MigrationStats,
                                                 float]:
        """Compact a page list onto the lowest free ids (possibly on other
        shards) and return ``(new_pages, stats, new_hit_rate)``.

        ``mode="remap"`` (default): the live pages keep their physical
        slots and are *renumbered* onto dense virtual ids — page-table
        writes only, no descriptor chain, empty ``MigrationStats``.
        ``mode="copy"`` is the legacy physical compaction (descriptor
        work through the runtime; the freed source slots return to their
        owners' free lists). Both modes leave identical logical contents
        under the returned refs — the ``tests/test_mmu.py`` oracle.
        """
        if mode not in ("remap", "copy"):
            raise ValueError(f"mode must be 'remap' or 'copy', got {mode!r}")
        refs = as_pagerefs(pages, api="ShardedKVPool.defragment")
        n = len(refs)
        if n == 0:
            return [], MigrationStats(), 1.0
        self.ensure_resident(refs)
        free_all = sorted(p for free in self._free for p in free)
        if mode == "remap":
            # Dense virtual ids: lowest free-slot ids whose vids are
            # unclaimed (identical to the copy-mode ids while the table
            # is identity), topped up from the unclaimed-vid pool.
            cand = [p for p in free_all if not self._vused[p]]
            if len(cand) < n:
                have = set(cand)
                cand += [int(v) for v in np.flatnonzero(~self._vused)
                         if int(v) not in have]
            if len(cand) < n:
                raise RuntimeError(f"defragment: need {n} free virtual "
                                   f"ids, have {len(cand)}")
            new = cand[:n]
            for nv, ov in zip(new, refs):
                s, slot = self.table.map(int(ov))
                self.table.remap(nv, s, slot)
                self._vused[nv] = True
                self._vused[int(ov)] = False
            rate = estimate_hit_rate(np.asarray(new, np.int64) * 32)
            return self.refs(new), MigrationStats(), rate
        if len(free_all) < n:
            raise RuntimeError(f"defragment: need {n} free pages, "
                               f"have {len(free_all)}")
        new_phys = free_all[:n]
        for p in new_phys:
            self._free[self.owner.owner(p)].remove(p)
        stats = self.rt.migrate_rows(
            (self.POOL_K, self.POOL_V),
            [self.table.slot_of(int(ov)) for ov in refs], new_phys)
        self.release(refs)
        out = [self._claim_vid(p) for p in new_phys]
        rate = estimate_hit_rate(np.asarray([int(p) for p in out],
                                            np.int64) * 32)
        return out, stats, rate


class ShardedServeEngine:
    """Continuous-batching serving over a sharded runtime.

    One :class:`repro_torch.serve.ServeEngine` per shard, each riding its
    shard's control channel for §II-D request completions. Admission is
    *ownership routing*: a request goes to the shard owning the majority
    of its KV pages (ties to the lowest shard; page-less requests
    round-robin by uid). Pages the winning shard does not own are
    migrated in first — the remote read becomes a migration chain — so by
    the time the request decodes, all of its pages are shard-local.
    """

    def __init__(self, params, cfg, *, runtime: ShardedDMARuntime,
                 kv_pool: Optional[ShardedKVPool] = None,
                 capacity: int = 2, max_len: int = 64, greedy: bool = True):
        from repro_torch.serve import ServeEngine
        if kv_pool is not None and kv_pool.rt is not runtime:
            raise ValueError("kv_pool must live on the same sharded runtime")
        self.rt = runtime
        self.kv = kv_pool
        self.engines = [
            ServeEngine(params, cfg, capacity=capacity, max_len=max_len,
                        greedy=greedy, runtime=rt, device=rt.device)
            for rt in runtime.shards]
        self.shard_of: Dict[int, int] = {}       # uid -> shard
        self.request_pages: Dict[int, List[int]] = {}
        self.requests_per_shard = [0] * runtime.num_shards
        self.remote_page_reads = 0
        self.migration = MigrationStats()
        # Pages may be shared across requests; a migrated-away source is
        # only freed once no admitted-but-undelivered request still reads
        # it (the migration copies contents, so earlier readers keep
        # valid data on the original page).
        self._page_refs: Dict[int, int] = {}
        self._deferred_free: set = set()
        self._unreffed: set = set()              # uids already decreffed

    # -- routing -------------------------------------------------------------
    def _route(self, uid: int, kv_pages: Optional[Sequence[int]]) -> int:
        if not kv_pages or self.kv is None:
            # No pages (or no pool to own them): deterministic round-robin.
            return uid % self.rt.num_shards
        counts = np.zeros(self.rt.num_shards, np.int64)
        for p in kv_pages:
            # Page-table truth: an ownership flip re-routes immediately,
            # before any byte of the page has moved.
            counts[self.kv.owner_of(p)] += 1
        return int(np.argmax(counts))   # argmax ties -> lowest shard

    def submit(self, req):
        """Admit a request to the shard owning its KV pages.

        Unified form: a :class:`~repro_torch.runtime.SubmitRequest` whose
        ``request`` field is the serve ``Request``; returns a
        :class:`~repro_torch.runtime.Ticket` with ``shard`` and ``uid`` set.
        The legacy positional-``Request`` form was removed one release
        after 0.4 and raises ``TypeError``. Remote pages are migrated
        into the owner first.
        """
        if not isinstance(req, SubmitRequest):
            reject_legacy_submit("ShardedServeEngine.submit", req)
        if req.request is None:
            raise ValueError(
                "ShardedServeEngine.submit needs SubmitRequest.request "
                "set to a serve Request")
        return self._admit(req.request, on_complete=req.on_complete)

    def _admit(self, req, on_complete=None) -> Ticket:
        kv_pages = list(getattr(req, "kv_pages", None) or [])
        if kv_pages and self.kv is not None:
            # Request.kv_pages is a PageRef surface; the shim coerces
            # bare ints (one DeprecationWarning per request).
            kv_pages = list(as_pagerefs(kv_pages, api="Request.kv_pages"))
        shard = self._route(req.uid, kv_pages)
        if kv_pages and self.kv is not None:
            # Dedupe: a page listed twice still migrates (and frees) once.
            remote = list(dict.fromkeys(
                p for p in kv_pages
                if self.kv.owner_of(p) != shard))
            if remote:
                new_local = self.kv.alloc_on(shard, len(remote))
                # Hop spans of this pull-in carry the originating request.
                with self.rt.trace_context(uid=req.uid):
                    stats = self.kv.move_pages(remote, new_local)
                # Counted only once the pull-in actually happened, so the
                # counter always matches the merged migration stats.
                self.remote_page_reads += len(remote)
                self.migration.merge(stats)
                # Free a migrated source only when no earlier live
                # request still references it; shared pages wait on the
                # deferred list until their last reader is delivered.
                shared = {p for p in remote
                          if self._page_refs.get(p, 0) > 0}
                self.kv.release([p for p in remote if p not in shared])
                self._deferred_free.update(shared)
                remap = dict(zip(remote, new_local))
                kv_pages = [remap.get(p, p) for p in kv_pages]
                if hasattr(req, "kv_pages"):
                    req.kv_pages = list(kv_pages)
        for p in set(kv_pages):
            self._page_refs[p] = self._page_refs.get(p, 0) + 1
        self.request_pages[req.uid] = kv_pages
        self.shard_of[req.uid] = shard
        self.requests_per_shard[shard] += 1
        t = self.engines[shard].submit(
            SubmitRequest(request=req, on_complete=on_complete))
        return dataclasses.replace(t, shard=shard)

    # -- stepping ------------------------------------------------------------
    def step(self) -> None:
        for eng in self.engines:
            eng.step()

    def run(self, max_steps: int = 1000) -> Dict[int, object]:
        for _ in range(max_steps):
            if not any(eng.queue or any(s.busy for s in eng.slots)
                       for eng in self.engines):
                break
            self.step()
        # Deliver through the poll path so page refcounts (and deferred
        # frees of migrated-away shared pages) always settle, whichever
        # API the caller drives.
        self.poll_completed()
        out: Dict[int, object] = {}
        for eng in self.engines:
            out.update(eng.completed)
        return out

    def poll_completed(self) -> List[object]:
        done: List[object] = []
        for eng in self.engines:
            done.extend(eng.poll_completed())
        for req in done:
            uid = req.uid
            if uid in self._unreffed:
                continue
            self._unreffed.add(uid)
            for p in set(self.request_pages.get(uid, [])):
                self._page_refs[p] = self._page_refs.get(p, 1) - 1
                if self._page_refs[p] <= 0 and p in self._deferred_free:
                    self._deferred_free.discard(p)
                    self.kv.release([p])
        return done

    # -- counters ------------------------------------------------------------
    def attach_probe(self, probe: Optional[PerfProbe]) -> None:
        for eng in self.engines:
            eng.attach_probe(probe)

    def attach_tracer(self, tracer: Optional[Tracer]) -> None:
        """One tracer observes the whole mesh: per-shard serve loops on
        ``shard{i}/serve`` tracks, runtimes under ``shard{i}/`` prefixes,
        migration hops via the sharded runtime's flow spans."""
        self.rt.attach_tracer(tracer)
        for s, eng in enumerate(self.engines):
            # The runtime tracks were already prefixed by rt.attach_tracer;
            # re-prefixing here is idempotent (same prefix, same names).
            eng.attach_tracer(tracer, track=f"shard{s}/serve",
                              track_prefix=f"shard{s}/")

    def request_latency_histogram(self) -> Histogram:
        """Mesh-wide request latency: per-shard histograms merged.

        The fixed bucket layout makes the merge plain element-wise count
        addition — associative, so shard order never matters (DESIGN.md §8).
        """
        merged = Histogram()
        for eng in self.engines:
            merged.merge(eng.request_latency)
        return merged

    def perf_counters(self) -> PerfCounters:
        """Mesh counters under the unified ``sharded.*`` namespace.

        Canonical keys are ``sharded.<field>`` plus a nested
        ``translation`` block; the old bare-key aliases were removed one
        release after 0.4 (DESIGN.md §9). Per-shard blocks under
        ``sharded.per_shard`` are ``serve.*``-namespaced.
        """
        per = [eng.perf_counters() for eng in self.engines]
        latency = self.request_latency_histogram()
        raw = {
            "num_shards": self.rt.num_shards,
            "requests_per_shard": list(self.requests_per_shard),
            "remote_page_reads": self.remote_page_reads,
            "migration": dataclasses.asdict(self.migration),
            # Virtual paging (DESIGN.md §11): lazy pulls landed after
            # ownership flips, plus the page table's mutation clock (any
            # remap/flip/pull bumps it — forensics for stale handles).
            "first_touch_pulls": self.kv.first_touch_pulls,
            "page_table_generation": self.kv.table.generation,
            "page_table_remaps": self.kv.table.remaps,
            "pending_pages": len(self.kv.table.pending_pages()),
            "steps": max(p["serve.steps"] for p in per),
            "completed": sum(p["serve.completed"] for p in per),
            "admission_stalls": sum(p["serve.admission_stalls"]
                                    for p in per),
            # Mesh-wide tail latency: per-shard histograms merged (steps
            # are scheduling outcomes, so these are seed-deterministic).
            "request_latency_steps_p50": latency.percentile(50),
            "request_latency_steps_p99": latency.percentile(99),
            "request_latency_steps": latency.snapshot(),
            "per_shard": per,
        }
        # Mesh-wide translation-cache counters: per-engine blocks are
        # in per_shard; this is their sum (DESIGN.md §7).
        return namespaced(
            raw, "sharded",
            extra={"translation": self.rt.translation_stats()})
