"""Bus constants of the paper's cycle model (§III), as the port needs them.

Only the constants and Eq. (1) that :mod:`repro_torch.core.prefetch`
reads are here so far; the cycle simulator itself is not ported yet
(ROADMAP.md lists it with the ``dma`` sweep).
"""
from __future__ import annotations

BUS_BYTES = 8          # 64-bit data bus
PIPE = 2               # fixed request+response pipeline stages
DESC_BYTES = 32        # our 256-bit descriptor
OURS_DESC_BEATS = DESC_BYTES // BUS_BYTES   # 4 beats


def ideal_utilization(n_bytes: int) -> float:
    """Eq. (1): every n-byte payload costs one 32 B descriptor of bus traffic."""
    return n_bytes / (n_bytes + DESC_BYTES)
