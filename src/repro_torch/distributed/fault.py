"""Elastic scaling: restore a checkpoint onto a *different* mesh topology,
and lose a shard of the sharded serving layer.

On node failure the controller rebuilds a smaller mesh (e.g. 2 pods -> 1),
calls :func:`reshard_checkpoint` to land the last committed state on the new
topology, and training resumes — the checkpoint manifest (descriptor-style
array records, DESIGN.md §3) carries everything needed. Meshes here are
process meshes (``launch.mesh.make_process_mesh``): every rank of the new
world calls these, and each gets its block of every leaf.

The serving-side counterpart is :func:`ungraceful_resize`: losing a shard
while fabric tickets are in flight is treated as an unplanned mesh resize
(DESIGN.md §10) — outstanding hops are re-routed, the lost shard's live
pages are handed off to survivors, and the mesh quiesces on N-1 shards.

The lost shard's "recovered image" is its pools as they stand: the port's
pools are the same tensors the drains write in place, so the recovery
drain reads every byte an egress gather was submitted to read (each
channel drains in submission order, as in the JAX package).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from .fabric import IN_FLIGHT, INGRESS
from .sharding import train_state_block_specs


def reshard_checkpoint(ckpt, step: int, cfg, new_mesh,
                       state_shapes: Any) -> Tuple[Any, dict]:
    """Restore ``step`` as this rank's blocks on ``new_mesh``.

    ``state_shapes`` is the TrainState shape tree for the *same model* (the
    mesh changes placement, not shapes), e.g. ``param_shapes`` on the meta
    device with moments of the same shapes.
    """
    specs = train_state_block_specs(cfg, new_mesh, state_shapes)
    return ckpt.restore(step, state_shapes, mesh=new_mesh, specs=specs)


def survive_shrink(ckpt, cfg, state_shapes: Any, make_mesh, *,
                   max_attempts: int = 3) -> Optional[Tuple[Any, dict, Any]]:
    """Controller-side recovery loop: try the meshes ``make_mesh(attempt)``
    gives (progressively smaller ones) until the latest committed
    checkpoint restores onto one. Returns ``(state, extra, mesh)``, or
    None without a committed checkpoint."""
    step = ckpt.latest_step()
    if step is None:
        return None
    last_err = None
    for attempt in range(max_attempts):
        try:
            mesh = make_mesh(attempt)
            state, extra = reshard_checkpoint(ckpt, step, cfg, mesh,
                                              state_shapes)
            return state, extra, mesh
        except Exception as e:  # noqa: BLE001 — controller retries smaller
            last_err = e
    raise RuntimeError(
        f"elastic recovery failed after {max_attempts} topologies: {last_err}")


def ungraceful_resize(kv, lost_shard: int, *,
                      priority: int = 0) -> Dict[int, int]:
    """Treat a lost shard as an unplanned mesh resize (DESIGN.md §10).

    Must be called while the async fabric may still hold tickets touching
    ``lost_shard``. Recovery follows the checkpoint-restore contract — the
    lost node's host-visible state (last committed image) stays readable
    even though the device is gone — so every page the shard held,
    including pages mid-migration, lands exactly once on a survivor:

    1. outstanding egress gathers on the lost shard complete from the
       recovered image (one recovery drain);
    2. in-flight tickets *destined to* the lost shard are re-routed: new
       pages on the survivor with the most free capacity, staged payloads
       re-placed, and a fresh §II-D control descriptor on the new
       destination (the old writeback slot died with the shard);
    3. the shard's remaining live pages — minus pages already leaving on
       outstanding hops, which arrive via (1)+(2) — are evacuated through
       the planner placement (``ShardedKVPool.evacuate``);
    4. the fabric pumps to quiescence on the surviving mesh.

    Returns the combined ``{old_page: new_page}`` remap (re-routed hop
    destinations plus evacuated pages); callers rewrite references.
    """
    srt = kv.rt
    if srt.fabric_mode != "async":
        raise RuntimeError("ungraceful_resize requires fabric='async'")
    if not srt.active[lost_shard]:
        raise ValueError(f"shard {lost_shard} already left the mesh")
    survivors = [s for s in srt.active_shards() if s != lost_shard]
    if not survivors:
        raise RuntimeError("no surviving shards to resize onto")
    pps = kv.owner.pages_per_shard
    remap: Dict[int, int] = {}

    # (1) recovery drain: outstanding egress gathers source their bytes
    # from the checkpointed image of the lost shard.
    srt.shards[lost_shard].drain_until_idle()

    # (2) re-route tickets destined to the lost shard.
    rerouted: set = set()
    for t in srt._pending_hops:
        if t.dst_shard != lost_shard:
            continue
        old_pages = [lost_shard * pps + int(r) for r in t.rows_d]
        rerouted.update(old_pages)
        target = max(survivors,
                     key=lambda s: (kv.free_pages_on(s), -s))
        new_pages = kv.alloc_on(target, len(old_pages))
        old_dst = srt.shards[t.dst_shard]
        if t.state == INGRESS:
            # Scatter chains already queued on the dead shard are
            # abandoned; the staged payload is still addressable there
            # (recovered image) — recapture it for the new destination.
            for name in t.pool_names:
                stage = srt._stage_name(t.hop_id, name)
                t.staged[name] = old_dst.pool(stage)
                old_dst.pools.pop(stage, None)
            t.ingress = []
        if t.state in (IN_FLIGHT, INGRESS):
            t.staged = {name: srt._place(target, arr)
                        for name, arr in t.staged.items()}
        t.dst_shard = target
        t.rows_d = np.asarray(
            [kv.owner.local_row(kv.table.slot_of(int(p)))
             for p in new_pages], np.int64)
        ctrl = srt.shards[target].submit_control(payload=t.src_shard,
                                                 channel="completion")
        t.ctrl_ticket = ctrl.tickets[-1]
        if t.state == INGRESS:
            srt._submit_ingress(t)
        remap.update(zip(old_pages, new_pages))

    # (3) hand off the shard's remaining live pages; pages leaving on an
    # outstanding hop arrive at their hop destination instead.
    # Re-routed hop destinations were allocated slots that never held
    # content — their remap entry already points at the new destination,
    # so evacuation must not remap them a second time.
    leaving = set(rerouted)
    for t in srt._pending_hops:
        # Includes IN_FLIGHT/INGRESS sources: already staged off the
        # shard, but their page ids stay allocated until the caller
        # releases them — evacuating them too would duplicate content.
        if t.src_shard == lost_shard:
            leaving.update(lost_shard * pps + int(r) for r in t.rows_s)
    remap.update(kv.evacuate(lost_shard, priority=priority,
                             exclude=sorted(leaving)))

    # (4) quiesce on the surviving mesh.
    srt.pump_until_idle()
    srt.drain_until_idle()
    return remap
