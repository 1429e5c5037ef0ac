"""Area/timing models (§III-A, Tables II-III) — the paper's fitted formulas.

We cannot synthesize RTL here; the paper itself distills its synthesis
campaign into a linear model, which we reproduce and validate against the
published configuration points.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# A[kGE] = 20.30 + 5.28 d + 1.94 s  (d = descriptors in flight, s = spec slots)
AREA_BASE_KGE = 20.30
AREA_PER_INFLIGHT_KGE = 5.28
AREA_PER_SPEC_KGE = 1.94

# Table II (GF12LP+, typical corner, 25C, 0.8V)
TABLE_II: Dict[str, Dict] = {
    "base":        {"frontend_kge": 25.8, "backend_kge": 15.4, "total_kge": 41.2, "fmax_ghz": 1.71},
    "speculation": {"frontend_kge": 34.8, "backend_kge": 14.7, "total_kge": 49.5, "fmax_ghz": 1.44},
    "scaled":      {"frontend_kge": 151.1, "backend_kge": 37.3, "total_kge": 188.4, "fmax_ghz": 1.23},
}

# Table III (Kintex-7 @ 200 MHz)
TABLE_III: Dict[str, Dict] = {
    "base":        {"luts": 2610, "ffs": 3090, "brams": 0},
    "speculation": {"luts": 2480, "ffs": 3935, "brams": 0},
    "scaled":      {"luts": 6764, "ffs": 11353, "brams": 0},
    "LogiCORE":    {"luts": 2784, "ffs": 5133, "brams": None},  # paper: ours needs none
}

# Whole-SoC context (CVA6 SoC on Genesys 2): 79142 LUTs / 58086 FFs.
SOC_LUTS, SOC_FFS = 79142, 58086


def area_kge(in_flight: int, spec_slots: int) -> float:
    """The paper's fitted area model; linear in d and s (scalability claim)."""
    return AREA_BASE_KGE + AREA_PER_INFLIGHT_KGE * in_flight + AREA_PER_SPEC_KGE * spec_slots


@dataclasses.dataclass(frozen=True)
class AreaReport:
    config: str
    in_flight: int
    spec_slots: int
    model_kge: float
    published_kge: float | None
    fmax_ghz: float | None

    @property
    def rel_err(self) -> float | None:
        if self.published_kge is None:
            return None
        return abs(self.model_kge - self.published_kge) / self.published_kge


def report(config: str, in_flight: int, spec_slots: int) -> AreaReport:
    pub = TABLE_II.get(config)
    return AreaReport(
        config=config, in_flight=in_flight, spec_slots=spec_slots,
        model_kge=area_kge(in_flight, spec_slots),
        published_kge=pub["total_kge"] if pub else None,
        fmax_ghz=pub["fmax_ghz"] if pub else None,
    )


def headline_fpga_savings() -> Dict[str, float]:
    """Paper abstract: 11% fewer LUTs / 23% fewer FFs vs LogiCORE (speculation cfg)."""
    ours, lc = TABLE_III["speculation"], TABLE_III["LogiCORE"]
    return {
        "lut_savings": 1 - ours["luts"] / lc["luts"],
        "ff_savings": 1 - ours["ffs"] / lc["ffs"],
    }
