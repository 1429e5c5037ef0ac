"""Transform-engine cells of the perf sweep (schema v6, DESIGN.md §9).

One cell per (transfer size, memory latency) point of the in-flight
transform surface: the cycle model runs the cached-artifact frontend
twice at the same *logical* payload — once charging full fp32 payload
beats, once charging the EF-int8 compressed beat count
(``payload_ratio = compression_ratio()``) — and the cell gates the
effective bandwidth of each plus their ratio. A quantized KV transfer
must move fewer bus beats for the *same* logical bytes, so the gain
gates strictly above 1.0 against the committed baseline.

The fidelity leg runs the seeded quantize→dequantize roundtrip through
the numpy oracle (:func:`repro_torch.core.transform.kv8_roundtrip_np`) and
gates the worst-case error — "equal fidelity tolerance" in the v6
contract: bandwidth wins never get to trade away roundtrip accuracy
silently. The fusion leg drives a real :class:`repro_torch.runtime.DMARuntime`
with ``kv_int8`` submissions and gates the transform-fusion hit rate of
the chain-lowering JIT (transform token in the
:class:`~repro_torch.core.signature.ChainSignature` — every plan should be
served by a transform-fused compiled executor).

Determinism contract: identical to the DMA cells — metrics are pure
functions of ``(seed, cell_key)``; no wall-clock value is stored.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Tuple

import numpy as np

#: Gated transform-cell metrics (gate.py carries polarity + bands).
TRANSFORM_GATED_METRICS = (
    "effective_bandwidth_fp32",
    "effective_bandwidth_int8",
    "effective_bandwidth_gain",
    "fidelity_max_rel_err",
    "transform_fusion_hit_rate",
)


@dataclasses.dataclass(frozen=True)
class TransformCellSpec:
    """Fully determines the transform cells (and hence their baselines)."""

    transfer_bytes: Tuple[int, ...] = (1024, 4096)
    full_transfer_bytes: Tuple[int, ...] = (512, 1024, 4096, 16384)
    mem_latencies: Tuple[int, ...] = (13, 100)
    full_mem_latencies: Tuple[int, ...] = (1, 13, 100)
    num_transfers: int = 512
    fidelity_elems: int = 4096     # multiple of the EF-int8 block (256)
    fusion_chains: int = 8
    fusion_segments: int = 4
    fusion_unit: int = 64          # elements per fused-loop segment

    def cell_key(self, nbytes: int, mem_latency: int) -> str:
        return f"transform/kv{nbytes}B/L{mem_latency}"


DEFAULT_TRANSFORM_SPEC = TransformCellSpec()


def _effective_bandwidth(mem_latency: int, nbytes: int,
                         num_transfers: int, payload_ratio: float) -> float:
    """Logical bytes per bus cycle through the cached-artifact frontend.

    The numerator is always the *uncompressed* payload — the transform
    changes what crosses the bus, not what the workload asked to move —
    so a payload_ratio < 1 shows up directly as higher effective
    bandwidth at equal logical traffic.
    """
    from repro_torch.core.simulator import SimConfig, simulate
    r = simulate(SimConfig.translated_frontend(), mem_latency, nbytes,
                 num_transfers=num_transfers, payload_ratio=payload_ratio)
    return float(num_transfers * nbytes / max(r.cycles, 1))


def _fidelity_pass(seed: int, key: str, elems: int) -> float:
    """Worst-case EF-int8 roundtrip error of a seeded KV-shaped pool.

    Mixed magnitudes per block (unit-scale values next to large
    outliers) make this the adversarial case for per-block scales; the
    error is normalized by the pool's max magnitude, matching the
    per-block symmetric-scale error model (bounded near 1/254).
    """
    from repro_torch.core.transform import kv8_roundtrip_np
    rng = np.random.default_rng([seed, zlib.crc32(key.encode())])
    x = rng.standard_normal(elems).astype(np.float32)
    outliers = rng.random(elems) < 0.05
    x = np.where(outliers, x * 64.0, x).astype(np.float32)
    y = kv8_roundtrip_np(x)
    return float(np.max(np.abs(y - x)) / max(float(np.max(np.abs(x))), 1e-12))


def _fusion_pass(seed: int, spec: TransformCellSpec, device=None) -> float:
    """Transform-fusion hit rate of a real runtime under kv_int8 traffic,
    on ``device`` (``cuda`` unless given)."""
    import torch

    from repro_torch.core.chain import from_segments
    from repro_torch.runtime import ChannelConfig, DMARuntime, SubmitRequest

    rng = np.random.default_rng([seed, 0x7F5])
    unit = spec.fusion_unit
    pool = 64 * unit
    rt = DMARuntime([ChannelConfig(name="ch0", tier="serial",
                                   ring_capacity=256, max_len=512)],
                    device=device)
    rt.register_pool("src", torch.zeros(pool, dtype=torch.float32,
                                        device=rt.device))
    rt.register_pool("dst", torch.zeros(pool, dtype=torch.float32,
                                        device=rt.device))
    n_slots = pool // unit
    for _ in range(spec.fusion_chains):
        src = rng.choice(n_slots, spec.fusion_segments, replace=False)
        dst = rng.choice(n_slots, spec.fusion_segments, replace=False)
        d = from_segments(src * unit, dst * unit,
                          np.full(spec.fusion_segments, unit, np.int64))
        rt.submit(SubmitRequest(chain=d, src_pool="src", dst_pool="dst",
                                tier="serial", transform="kv_int8"))
    rt.drain_until_idle()
    st = rt._translation_stats_raw()
    return float(st["transform_fusion_hit_rate"])


def transform_cell_entries(
    seed: int,
    spec: TransformCellSpec = DEFAULT_TRANSFORM_SPEC,
    *,
    quick: bool = True,
    device=None,
) -> List[Tuple[str, Dict[str, object]]]:
    """All (key, cell dict) transform entries for the sweep document; the
    fusion leg's runtime runs on ``device`` (``cuda`` unless given)."""
    from repro_torch.optim.compress import compression_ratio

    ratio = compression_ratio()
    fusion = _fusion_pass(seed, spec, device)
    sizes = spec.transfer_bytes if quick else spec.full_transfer_bytes
    lats = spec.mem_latencies if quick else spec.full_mem_latencies
    entries: List[Tuple[str, Dict[str, object]]] = []
    for nbytes in sizes:
        for mem_latency in lats:
            key = spec.cell_key(nbytes, mem_latency)
            fidelity = _fidelity_pass(seed, key, spec.fidelity_elems)
            bw_fp32 = _effective_bandwidth(mem_latency, nbytes,
                                           spec.num_transfers, 1.0)
            bw_int8 = _effective_bandwidth(mem_latency, nbytes,
                                           spec.num_transfers, ratio)
            entries.append((key, {
                "kind": "transform",
                "workload": "kv_int8",
                "transfer_bytes": nbytes,
                "mem_latency": mem_latency,
                "metrics": {
                    "effective_bandwidth_fp32": bw_fp32,
                    "effective_bandwidth_int8": bw_int8,
                    "effective_bandwidth_gain":
                        bw_int8 / max(bw_fp32, 1e-12),
                    "fidelity_max_rel_err": fidelity,
                    "transform_fusion_hit_rate": fusion,
                },
                "counters": {
                    "payload_ratio": ratio,
                    "num_transfers": spec.num_transfers,
                },
            }))
    return entries
