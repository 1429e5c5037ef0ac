"""Three-term roofline on NVIDIA H100 peaks.

    compute    = FLOPs per chip / 989.4 TFLOP/s (dense bf16)
    memory     = bytes per chip / 3.35 TB/s (HBM3)
    collective = wire bytes per chip / (18 links x 25 GB/s)

The peaks are the NVIDIA H100 SXM5 80GB data sheet's, for the card at its
full power limit (NVIDIA H100 80GB HBM3, 700 W); a card set below 700 W
runs slower under load, so a share against these peaks is stated with the
card's power limit beside it. NVLink 4 gives a chip 900 GB/s in both
directions together: 18 links of 25 GB/s a direction, so one direction of
a ring collective moves at most ``LINKS_PER_CHIP * LINK_BW`` = 450 GB/s.

The counts come from :mod:`repro_torch.launch.dryrun` (a FLOP and byte
count of the port's own step on the meta device), or from an HLO text,
which :func:`collective_bytes` parses as the reference does: each
collective's per-partition tensor bytes times a ring wire factor
(all-reduce 2x, all-gather/reduce-scatter/all-to-all/permute 1x). The port
partitions no program, so its dry run has no wire bytes: a
:class:`Roofline` built without them reports the collective term as not
counted (``None``), not as 0, and takes the step time and bottleneck from
the terms that were counted.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

# NVIDIA H100 SXM5 80GB data sheet (NVIDIA H100 80GB HBM3, 700 W).
PEAK_FLOPS = 989.4e12        # dense bf16 tensor-core FLOP/s per chip
PEAK_FLOPS_FP32 = 67e12      # fp32 on the CUDA cores (no tensor cores)
HBM_BW = 3.35e12             # bytes/s per chip, HBM3
LINK_BW = 25e9               # bytes/s one direction of one NVLink 4 link
LINKS_PER_CHIP = 18          # NVLink 4 links per H100 SXM5

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLLECTIVE_FACTORS = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "ragged-all-to-all": 1.0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"^\s*(?:%\S+|\S+)\s*=\s*(\([^)]*\)|\S+)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute|ragged-all-to-all)\(",
    re.M)


def _shape_bytes(shape_str: str) -> int:
    """Bytes of one HLO shape string like 'f32[16,128]' or a tuple thereof."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-chip wire bytes by collective kind, from partitioned HLO text."""
    out = {k: 0.0 for k in _COLLECTIVE_FACTORS}
    for m in _OP_RE.finditer(hlo_text):
        shape_str, kind = m.group(1), m.group(2)
        out[kind] += _shape_bytes(shape_str) * _COLLECTIVE_FACTORS[kind]
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    wire_bytes_per_chip: Optional[float]   # None: not counted
    collectives: Optional[Dict[str, float]]
    model_flops: float            # 6 * N(active) * tokens (global)
    bytes_per_chip_hbm: Optional[float]    # peak allocation; None: unknown

    @property
    def compute_s(self) -> float:
        return self.hlo_flops_per_chip / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> Optional[float]:
        if self.wire_bytes_per_chip is None:
            return None
        return self.wire_bytes_per_chip / (LINKS_PER_CHIP * LINK_BW)

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the counted terms (perfect overlap)."""
        return max(self._terms().values())

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global counted FLOPs) — remat/padding/causal waste."""
        total = self.hlo_flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs / (chips x peak x roofline step time)."""
        t = self.step_time_s
        return (self.model_flops / (self.chips * PEAK_FLOPS * t)) if t else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_chip": self.hlo_flops_per_chip,
            "hlo_bytes_per_chip": self.hlo_bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "collectives": self.collectives,
            "model_flops": self.model_flops,
            "bytes_per_chip_hbm": self.bytes_per_chip_hbm,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
        }


# ---------------------------------------------------------------------------
# Loop-aware accounting (the reference's roofline method)
#
# Every per-depth cost is affine in the period count P, so two counts at
# P=1 and P=2 give exact totals:
#     F(P) = F(1) + (P - 1) * (F(2) - F(1)).
# The counts run with attention_impl="proj_only" and the core is added back
# analytically with the flash-streaming traffic model below.
# ---------------------------------------------------------------------------

# Train factors for the attention core under remat_policy="minimal"
# (batch-dim products are not saved -> recomputed in backward):
TRAIN_CORE_FLOPS_FACTOR = 4.0    # fwd 1x + recompute 1x + bwd 2x
TRAIN_CORE_BYTES_FACTOR = 3.5    # fwd 1x + recompute 1x + bwd ~1.5x
Q_BLOCK = 512                    # flash schedule q-block (K/V re-read factor)


def extrapolate(f1: float, f2: float, periods: int) -> float:
    return f1 + (periods - 1) * (f2 - f1)


def attention_core(cfg, shape, kind: str) -> Tuple[float, float]:
    """(flops, bytes) of ONE attention layer's core, global across chips.

    Flash-streaming traffic: Q read + O write once; K/V streamed once per
    q-block. Sliding-window layers only touch the (window + q_block) band.
    """
    b, s = shape.global_batch, shape.seq_len
    if cfg.mla is not None:
        h, kvh = cfg.num_heads, cfg.num_heads
        dqk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        dv = cfg.mla.v_head_dim
    else:
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        dqk = dv = cfg.head_dim_
    kv_len = s if kind != "local" or not cfg.sliding_window \
        else min(s, cfg.sliding_window + Q_BLOCK)
    # FLOPs: QK^T + AV (the blockwise schedule computes all tiles, masked).
    flops = 2.0 * b * s * kv_len * h * (dqk + dv)
    nq = max(1, s // Q_BLOCK)
    dt = 2  # bf16
    q_o = b * s * h * (dqk + dv) * dt
    kv = b * kv_len * kvh * (dqk + dv) * dt * nq
    byts = q_o + kv
    if shape.kind == "train":
        flops *= TRAIN_CORE_FLOPS_FACTOR
        byts *= TRAIN_CORE_BYTES_FACTOR
    return flops, byts


def core_totals(cfg, shape) -> Tuple[float, float]:
    """Analytic attention-core (flops, bytes) for the whole stack, global."""
    flops = byts = 0.0
    per_period = list(cfg.block_pattern)
    periods = (cfg.num_layers - cfg.first_k_dense) // len(per_period)
    layers = [(per_period[0][0])] * cfg.first_k_dense
    for _ in range(periods):
        layers.extend(m for m, _ in per_period)
    if cfg.is_encdec:
        layers.extend(["attn"] * cfg.encoder_layers)  # enc self-attn
        layers.extend(["attn"] * cfg.num_layers)      # dec cross-attn
    for kind in layers:
        if kind in ("attn", "local"):
            f, by = attention_core(cfg, shape, kind)
            flops += f
            byts += by
    return flops, byts


def model_flops(cfg, shape) -> float:
    """6*N*D for training; 2*N*D for a forward-only step (prefill/decode)."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def build(arch: str, shape, mesh_name: str, chips: int, cfg,
          cost: Dict, hlo_text: Optional[str],
          peak_bytes: Optional[float]) -> Roofline:
    """A :class:`Roofline` from per-chip ``cost`` (``flops``, ``bytes
    accessed``); ``hlo_text`` None leaves the collective term uncounted."""
    coll = None if hlo_text is None else collective_bytes(hlo_text)
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops_per_chip=float(cost.get("flops", 0.0)),
        hlo_bytes_per_chip=float(cost.get("bytes accessed", 0.0)),
        wire_bytes_per_chip=None if coll is None
        else float(sum(coll.values())),
        collectives=coll,
        model_flops=model_flops(cfg, shape),
        bytes_per_chip_hbm=None if peak_bytes is None else float(peak_bytes),
    )
