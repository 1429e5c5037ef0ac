"""One-shot seeded trace recorder: the ``--trace`` entrypoint.

``python -m repro_torch.obs.record --out serve.trace.json --mesh 2
--seed 0 [--device cpu]`` runs the reduced serve scenario with the tracer
attached to every layer — request-lifecycle async spans, channel
launch/drain spans, translation lookups, §II-D completion instants, and
(at ``--mesh`` >= 2) cross-shard migration hops linked by Perfetto flow
arrows — plus a short cycle-clock simulator pass, then writes the
Chrome/Perfetto ``trace_event`` JSON (DESIGN.md §8). ``--metrics-out``
additionally dumps the probe's metric registry as flat JSONL.

Everything is seeded: the same ``--seed`` replays the same request mix
and the same sampling decisions.
"""
from __future__ import annotations

import argparse
import sys
import zlib
from typing import Optional, Sequence, Tuple

from repro_torch.obs.export import write_chrome_trace, write_metrics_jsonl
from repro_torch.obs.trace import Tracer

#: The reduced serve scenario (mirrors the gated serve cell's shape).
_ARCH = "qwen2.5-3b"
_N_REQUESTS_PER_SHARD = 3
_CAPACITY = 2
_MAX_LEN = 32
_MAX_NEW_TOKENS = 4
_POLL_EVERY = 3
_MAX_STEPS = 400


def record_serve_trace(
    seed: int = 0,
    *,
    mesh: int = 1,
    sample_rate: float = 1.0,
    capacity: int = 65536,
    simulate: bool = True,
    device=None,
) -> Tuple[Tracer, object, dict]:
    """Run the seeded serve scenario under a tracer, on ``device``
    (``cuda`` unless given). Returns ``(tracer, probe, perf_counters)``.

    ``mesh == 1`` drives a plain :class:`repro_torch.serve.ServeEngine`;
    ``mesh >= 2`` drives a :class:`repro_torch.distributed.
    ShardedServeEngine` over logical shards with every third request's KV
    pages straddling shards, so the trace contains real migration hops
    (egress -> fabric -> ingress flow arrows).
    """
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime import SubmitRequest
    from repro_torch.runtime.instrumentation import PerfProbe
    from repro_torch.serve import Request, ServeEngine

    if mesh < 1:
        raise ValueError("mesh must be >= 1")
    tracer = Tracer(capacity=capacity, sample_rate=sample_rate, seed=seed)
    probe = PerfProbe()
    cfg = get_config(_ARCH, reduced=True)
    params = init_params(0, cfg, device)
    rng = np.random.default_rng([seed, zlib.crc32(b"obs.record")])

    def _prompt():
        n = int(rng.integers(2, 7))
        return [int(t) for t in rng.integers(1, cfg.vocab_size, n)]

    if mesh == 1:
        eng = ServeEngine(params, cfg, capacity=_CAPACITY, max_len=_MAX_LEN,
                          device=device)
        eng.attach_probe(probe)
        eng.attach_tracer(tracer)
        for uid in range(2 * _N_REQUESTS_PER_SHARD):
            eng.submit(SubmitRequest(request=Request(
                uid=uid, prompt=_prompt(), max_new_tokens=_MAX_NEW_TOKENS)))
        while ((eng.queue or any(s.busy for s in eng.slots))
               and eng.steps < _MAX_STEPS):
            eng.step()
            if eng.steps % _POLL_EVERY == 0:
                eng.poll_completed()
        eng.poll_completed()
        pc = eng.perf_counters()
    else:
        from repro_torch.distributed.sharded_runtime import (
            ShardedDMARuntime,
            ShardedKVPool,
            ShardedServeEngine,
        )
        srt = ShardedDMARuntime(num_shards=mesh, device=device)
        kv = ShardedKVPool(srt, num_pages=16 * mesh, page=2,
                           kv_heads=2, head_dim=4)
        eng = ShardedServeEngine(params, cfg, runtime=srt, kv_pool=kv,
                                 capacity=_CAPACITY, max_len=_MAX_LEN)
        eng.attach_probe(probe)
        eng.attach_tracer(tracer)
        for uid in range(mesh * _N_REQUESTS_PER_SHARD):
            home = uid % mesh
            pages = kv.alloc_on(home, 2)
            if uid % 3 == 2:
                # Straddle shards: the majority owner wins the route and
                # pulls the minority page across -> a real migration hop.
                pages = pages + kv.alloc_on((home + 1) % mesh, 1)
            eng.submit(SubmitRequest(request=Request(
                uid=uid, prompt=_prompt(),
                max_new_tokens=_MAX_NEW_TOKENS, kv_pages=pages)))
        eng.run(max_steps=_MAX_STEPS)
        pc = eng.perf_counters()

    if simulate:
        # A short cycle-clock pass so the exported timeline carries the
        # simulator's bus view (its own clock domain, own tracks).
        if mesh > 1:
            from repro_torch.core.simulator import simulate_sharded
            simulate_sharded(mesh, 2, 13, 64, num_transfers=40,
                             cross_fraction=0.25, seed=seed, tracer=tracer)
        else:
            from repro_torch.core.simulator import simulate_multichannel
            simulate_multichannel(2, 13, 64, num_transfers=40, seed=seed,
                                  tracer=tracer)
    return tracer, probe, pc


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.record",
        description="Record a seeded serve(+sharded) lifecycle trace as "
                    "Perfetto-loadable trace_event JSON (DESIGN.md §8).")
    ap.add_argument("--out", default="serve.trace.json",
                    help="trace JSON path (load at ui.perfetto.dev)")
    ap.add_argument("--metrics-out",
                    help="also dump the probe's metric registry as JSONL")
    ap.add_argument("--seed", type=int, default=0,
                    help="scenario + sampling seed (same seed, same trace "
                         "structure)")
    ap.add_argument("--mesh", type=int, default=1,
                    help=">= 2 runs the sharded serve path: per-shard "
                         "track groups plus migration-hop flow arrows")
    ap.add_argument("--sample-rate", type=float, default=1.0,
                    help="deterministic per-key sampling fraction")
    ap.add_argument("--capacity", type=int, default=65536,
                    help="tracer ring size (oldest events drop beyond it)")
    ap.add_argument("--no-sim", action="store_true",
                    help="skip the cycle-clock simulator pass")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    tracer, probe, pc = record_serve_trace(
        args.seed, mesh=args.mesh, sample_rate=args.sample_rate,
        capacity=args.capacity, simulate=not args.no_sim,
        device=args.device)
    events = tracer.events()
    doc = write_chrome_trace(args.out, events)
    tracks = sorted({e.track for e in events})
    names = sorted({e.name for e in events})
    print(f"wrote {args.out}: {len(doc['traceEvents'])} trace events "
          f"({len(events)} recorded, {tracer.dropped} dropped) on "
          f"{len(tracks)} tracks")
    print(f"  tracks: {', '.join(tracks)}")
    print(f"  events: {', '.join(names)}")
    ns = "sharded" if args.mesh > 1 else "serve"
    print(f"  request latency steps: "
          f"p50={pc[f'{ns}.request_latency_steps_p50']:.1f} "
          f"p99={pc[f'{ns}.request_latency_steps_p99']:.1f} "
          f"(n={pc[f'{ns}.request_latency_steps']['n']})")
    if args.metrics_out:
        n = write_metrics_jsonl(args.metrics_out, probe.metrics)
        print(f"wrote {args.metrics_out}: {n} metrics")
    return 0


if __name__ == "__main__":
    sys.exit(main())
