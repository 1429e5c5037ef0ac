"""Operations and bytes of the program's kernels, from the shapes a call
takes: frozen copies of the hardware check's counts (flash attention
forward and backward; the expert gather and combine and their
backwards). Each counts every input byte read once and every output byte
written once, and the operations the inputs need."""
from __future__ import annotations


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal mask lets through at Sq = Sk = s."""
    return s * (s + 1) // 2


def flash_forward(b: int, s: int, h: int, kv: int, d: int, dv: int,
                  elem: int) -> tuple:
    """(bytes, operations) of one causal forward: q, k, v read once, the
    output (B, S, H, DV) written once; 2 (D + DV) operations a visible
    pair."""
    n_bytes = (b * s * h * d + b * s * kv * d + b * s * kv * dv
               + b * s * h * dv) * elem
    return n_bytes, 2 * b * h * (d + dv) * causal_pairs(s)


def flash_backward(b: int, s: int, h: int, kv: int, d: int, dv: int,
                   elem: int) -> tuple:
    """(bytes, operations) of one causal backward: q, k, v, dO and the fp32
    log-sum-exp read once, dQ, dK, dV written once; a visible pair takes
    2 D (S again), 2 DV (dO V^T), 2 DV (dV), 2 D (dQ) and 2 D (dK)."""
    q, k, v = b * s * h * d, b * s * kv * d, b * s * kv * dv
    n_bytes = 2 * (q + k + v) * elem + b * s * h * dv * elem + b * h * s * 4
    return n_bytes, 2 * b * h * causal_pairs(s) * (3 * d + 2 * dv)


def moe_gather(t: int, k: int, slots: int, d: int, elem: int) -> tuple:
    """The dispatch gather: every kept copy's token row read once, every
    slot row written once, the slot stream read (dropless: T k kept)."""
    kept = t * k
    return kept * d * elem + slots * d * elem + 4 * slots, 0


def moe_combine(t: int, k: int, slots: int, d: int, elem: int) -> tuple:
    """The weighted combine: each kept copy's expert row and the inverse
    streams read, every token row written; 2 operations an element."""
    kept = t * k
    return kept * d * elem + t * d * elem + 8 * t * k, 2 * kept * d


def moe_gather_bwd(t: int, k: int, slots: int, d: int, elem: int) -> tuple:
    """The gather's backward (the combine kernel at unit weights): each
    kept copy's slot row and the inverse stream read, every token row
    written."""
    kept = t * k
    return kept * d * elem + 4 * t * k + t * d * elem, kept * d


def moe_combine_bwd(t: int, k: int, slots: int, d: int, elem: int) -> tuple:
    """The combine's backward: dy, each kept copy's expert row and the
    streams read, every slot row and the weights' gradient written."""
    kept = t * k
    n_bytes = t * d * elem + kept * d * elem + 8 * t * k + 4 * slots \
        + slots * d * elem + 4 * t * k
    return n_bytes, 3 * kept * d
