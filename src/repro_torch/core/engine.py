"""Descriptor execution engines — the DMA backend's semantics in PyTorch.

Tiers, all consuming a host-side :class:`DescriptorArray`:

* :func:`execute_chain_host` — numpy oracle with the RTL's serial semantics
  (walk the chain, copy segment by segment). Ground truth for everything.
* :func:`execute_serial` — chain-order engine over a fixed ``max_len``
  window (later descriptors may overwrite earlier ones, as in hardware).
* :func:`execute_blocked` — vectorized engine for uniform-unit streams: a
  masked gather/scatter executed in one shot.
* :func:`execute_blocked_2d` — the row-pool form the descriptor-copy kernel
  (:mod:`repro_torch.kernels.descriptor_copy`) accelerates.

The tiers are pure, like the JAX package's: they return a new destination
tensor on the pools' device and leave ``dst`` untouched. Three JAX
semantics are written out because torch has no counterpart:

* ``lax.dynamic_slice`` clamps a window's start to ``len - max_len`` near
  the pool tail; ``execute_serial`` clamps the same way.
* ``.at[].set(mode="drop")`` wraps negative indices once and drops the
  rest that fall outside the pool; :func:`scatter_drop` masks first.
* A scatter with duplicate destinations has no defined winner in XLA (nor
  in ``index_put_`` on CUDA). The port's rule is **last write wins in
  chain order**: only the last occurrence of each destination index is
  kept, on the host, before the scatter.

Completion follows §II-D: executed descriptors get the all-ones writeback
(``mark_done``), so a polling scheduler can observe progress without IRQs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .chain import walk_chain_host
from .descriptor import DescriptorArray


# ---------------------------------------------------------------------------
# Index helpers (host side)
# ---------------------------------------------------------------------------

def keep_last(idx: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``mask`` restricted to the last masked occurrence of each ``idx``."""
    pos = np.flatnonzero(mask)
    if pos.size == 0:
        return mask
    rev = pos[::-1]
    _, first_in_rev = np.unique(idx[rev], return_index=True)
    out = np.zeros_like(mask)
    out[rev[first_in_rev]] = True
    return out


def scatter_drop(out: torch.Tensor, idx: np.ndarray, vals: torch.Tensor,
                 valid: np.ndarray = None) -> torch.Tensor:
    """``out.at[idx].set(vals, mode="drop")`` in place, last write wins.

    ``idx`` (host, int64) indexes ``out``'s first axis; negative entries
    wrap once as in JAX, entries still outside ``[0, len)`` are dropped, and
    of duplicate indices only the last one writes. ``vals`` lies on
    ``out``'s device, one entry (row) per index.
    """
    size = out.shape[0]
    idx = np.where(idx < 0, idx + size, idx)
    keep = (idx >= 0) & (idx < size)
    if valid is not None:
        keep &= valid
    keep = keep_last(idx, keep)
    if not keep.any():
        return out
    sel = torch.from_numpy(np.flatnonzero(keep)).to(vals.device)
    tgt = torch.from_numpy(idx[keep]).to(out.device)
    out[tgt] = vals[sel]
    return out


def _host(t) -> np.ndarray:
    return np.asarray(t, np.int64)


# ---------------------------------------------------------------------------
# Host oracle
# ---------------------------------------------------------------------------

def execute_chain_host(
    d: DescriptorArray, src: np.ndarray, dst: np.ndarray, head: int = 0
) -> Tuple[np.ndarray, DescriptorArray]:
    """Serial reference: faithful chain-order copy on the host."""
    src = np.asarray(src)
    out = np.array(dst, copy=True)
    s, t, ln = (np.asarray(d.src), np.asarray(d.dst), np.asarray(d.length))
    order = walk_chain_host(d, head)
    for i in order:
        out[t[i] : t[i] + ln[i]] = src[s[i] : s[i] + ln[i]]
    dd = d.mark_done(np.asarray(order, np.int32))
    return out, dd


# ---------------------------------------------------------------------------
# Serial engine (chain-order preserving)
# ---------------------------------------------------------------------------

def execute_serial(
    d: DescriptorArray,
    src: torch.Tensor,
    dst: torch.Tensor,
    *,
    max_len: int,
    head: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Execute a chain serially through a fixed ``max_len`` window.

    Each step copies a masked window of ``max_len`` elements (hardware
    analogue: max burst). As ``lax.dynamic_slice`` does, a window that
    would run past a pool's end is moved back to end at the pool's last
    element. Reads come from ``src`` as it was before the call. Returns
    (dst', done').
    """
    if max_len > src.shape[0] or max_len > dst.shape[0]:
        raise ValueError(f"max_len {max_len} exceeds a pool length "
                         f"({src.shape[0]}, {dst.shape[0]})")
    n = d.num_descriptors
    s_all, t_all, ln_all = _host(d.src), _host(d.dst), _host(d.length)
    nxt = _host(d.nxt)
    out = dst.clone()
    done = d.done.clone()
    s_hi, t_hi = src.shape[0] - max_len, dst.shape[0] - max_len
    cur, steps = int(head), 0
    while cur >= 0:
        if steps > n:
            raise ValueError("descriptor chain contains a cycle")
        steps += 1
        s = min(max(int(s_all[cur]), 0), s_hi)
        t = min(max(int(t_all[cur]), 0), t_hi)
        k = min(max(int(ln_all[cur]), 0), max_len)
        if k:
            out[t:t + k] = src[s:s + k]
        done[cur] = 1
        cur = int(nxt[cur])
    return out, done


# ---------------------------------------------------------------------------
# Vectorized blocked engines
# ---------------------------------------------------------------------------

def execute_blocked(
    d: DescriptorArray, src: torch.Tensor, dst: torch.Tensor, *, unit: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized engine for streams whose lengths are all <= ``unit``.

    All descriptors execute "in parallel"; of overlapping destinations the
    last in descriptor order wins (callers needing chain-order semantics
    use ``execute_serial``). Disabled descriptors (length < 0, i.e.
    completed/sentinel) are skipped. As in the JAX engine, masked-off
    lanes target index ``len(src)`` with the value 0. Returns (dst', done').
    """
    n_src = src.shape[0]
    offs = np.arange(unit, dtype=np.int64)
    length = _host(d.length)
    active = length >= 0
    ln = np.maximum(length, 0)

    src_idx = np.clip(_host(d.src)[:, None] + offs[None, :], 0, n_src - 1)
    valid = (offs[None, :] < ln[:, None]) & active[:, None]
    dst_idx = np.where(valid, _host(d.dst)[:, None] + offs[None, :], n_src)

    rows = src[torch.from_numpy(src_idx.reshape(-1)).to(src.device)]
    vmask = torch.from_numpy(valid.reshape(-1)).to(src.device)
    vals = torch.where(vmask, rows, torch.zeros_like(rows))
    out = scatter_drop(dst.clone(), dst_idx.reshape(-1), vals)
    done = torch.where(torch.from_numpy(active), torch.ones_like(d.done),
                       d.done)
    return out, done


def execute_blocked_2d(
    d: DescriptorArray, src: torch.Tensor, dst: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-pool variant: src/dst are (rows, ...); descriptors move whole
    rows (src/dst fields are row indices, length is rows-per-descriptor == 1).

    This is the layout used by the paged-KV cache and MoE dispatch: a
    descriptor moves one fixed-size row (page line / token embedding), and
    irregularity lives entirely in the index pattern. Of duplicate
    destination rows the last active descriptor wins.
    """
    active = _host(d.length) >= 0
    safe_src = np.clip(_host(d.src), 0, src.shape[0] - 1)
    rows = src[torch.from_numpy(safe_src).to(src.device)]
    dst_idx = np.where(active, _host(d.dst), dst.shape[0])
    out = scatter_drop(dst.clone(), dst_idx, rows)
    done = torch.where(torch.from_numpy(active), torch.ones_like(d.done),
                       d.done)
    return out, done


# ---------------------------------------------------------------------------
# Completion / feedback logic (frontend §II-A "feedback logic")
# ---------------------------------------------------------------------------

def completion_events(done_before: torch.Tensor, done_after: torch.Tensor,
                      irq_mask: torch.Tensor) -> torch.Tensor:
    """Which descriptors completed this step AND requested notification.

    Mirrors the frontend's IRQ-optional design: descriptors with
    CONFIG_IRQ_ENABLE produce an event; everything else relies on the
    writeback being polled.
    """
    newly = (done_after == 1) & (done_before == 0)
    return newly & (irq_mask != 0)
