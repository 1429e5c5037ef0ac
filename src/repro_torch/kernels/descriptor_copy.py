"""Descriptor-driven row copy — the paper's DMAC as a CUDA kernel.

``descriptor_copy(src_idx, dst_idx, src, dst)`` performs
``dst[dst_idx[i]] = src[src_idx[i]]`` for each descriptor ``i`` over
``(rows, unit)`` row pools; a -1 on either side writes nothing. Rows are
the transfer unit (the fixed "burst"): irregularity lives entirely in the
descriptor index pattern, as in the paged-KV consumers.

The destination is updated **in place** and returned, as the TPU kernel
aliases its output to ``dst``.

Three implementations of one function:

* :func:`descriptor_copy` — the wrapper. For CUDA tensors it launches the
  kernel in ``csrc/descriptor_copy.cu`` (or raises); for CPU tensors it
  runs :func:`descriptor_copy_plain`. No fallback in between.
* :func:`descriptor_copy_plain` — the same function in plain PyTorch, on
  any device. The CPU tests use it; ``chip_smoke.py`` holds the kernel
  against it on the card.

Two rules that the TPU's in-order grid gave for free:

* **duplicate destinations** — of several active descriptors writing one
  row, only the last one writes (the TPU grid order). The plain version
  applies it on the host (``core/engine.keep_last``); the kernel applies
  it on the card, each block over the launch's descriptor table
  (:func:`repro_torch.kernels.ref.last_write_keep` models that rule);
* **aliasing** — when ``src`` and ``dst`` overlap in memory and an active
  source row is also an active destination row, the source rows are first
  copied to a scratch buffer, so every descriptor reads the pool as it was
  before the call (the JAX drains' snapshot semantics).

The index streams are host-side control state: numpy arrays or tensors on
any device. On the CUDA route they reach the card inside the launch, not
through a device buffer: the wrapper hands the library the bytes of two
contiguous int64 streams (a caller that passes such numpy arrays,
as ``runtime/lowering.py`` and ``runtime/channel.py`` do, pays no
conversion), and one C pass checks the indices' range, drops the -1
entries and packs the rest into the kernel's by-value table of 128, 512
or 4,088 int32 pairs, the smallest that holds them. More active
descriptors than 4,088 are cut into consecutive launches on one stream
(``MAX_TABLE``), each counted; nothing uploads and nothing synchronises.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.engine import keep_last

from .build import launch_table, refuse_grad


# ---------------------------------------------------------------------------
# Shared host-side preparation (also used by quantize_copy)
# ---------------------------------------------------------------------------

def host_indices(idx) -> np.ndarray:
    """A 1-D integer index stream as an int64 numpy array."""
    if isinstance(idx, torch.Tensor):
        if idx.dtype.is_floating_point or idx.dtype == torch.bool:
            raise TypeError(f"index stream must be integer, got {idx.dtype}")
        arr = idx.detach().cpu().numpy()
    else:
        arr = np.asarray(idx)
        if not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(f"index stream must be integer, got {arr.dtype}")
    if arr.ndim != 1:
        raise ValueError(f"index stream must be 1-D, got shape {arr.shape}")
    return arr.astype(np.int64)


def check_pools(src: torch.Tensor, dst: torch.Tensor, api: str) -> None:
    """Row pools: 2-D, contiguous, one dtype, one row width, one device."""
    if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
            and src.is_cuda and dst.is_cuda and src.dim() == 2
            and dst.dim() == 2 and src.dtype == dst.dtype
            and src.shape[1] == dst.shape[1]
            and src.get_device() == dst.get_device()
            and src.is_contiguous() and dst.is_contiguous()):
        return                  # pools on one card: every check below holds
    for name, t in (("src", src), ("dst", dst)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{api}: {name} must be a torch.Tensor")
        if t.ndim != 2:
            raise ValueError(f"{api}: {name} must be a (rows, unit) pool, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{api}: {name} must be contiguous")
    if src.dtype != dst.dtype:
        raise TypeError(f"{api}: dtype mismatch {src.dtype} vs {dst.dtype}")
    if src.shape[1] != dst.shape[1]:
        raise ValueError(f"{api}: row width mismatch "
                         f"{src.shape[1]} vs {dst.shape[1]}")
    if src.device != dst.device:
        raise ValueError(f"{api}: src on {src.device}, dst on {dst.device}")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{api}: unsupported device {src.device}")


def shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def prepare(src_idx, dst_idx, src: torch.Tensor, dst: torch.Tensor,
            api: str) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Index streams after the duplicate rule, and whether to snapshot.

    Returns ``(sidx, didx, snapshot)``: int64 host arrays in which only the
    last active descriptor per destination row stays active (the others
    become -1), and True when ``src`` and ``dst`` share storage and an
    active source row may be overwritten by the same call.
    """
    sidx, didx = host_indices(src_idx), host_indices(dst_idx)
    if sidx.shape != didx.shape:
        raise ValueError(f"{api}: {sidx.size} source vs {didx.size} "
                         "destination indices")
    active = (sidx >= 0) & (didx >= 0)
    if np.any(sidx[active] >= src.shape[0]) \
            or np.any(didx[active] >= dst.shape[0]):
        raise IndexError(f"{api}: row index out of range "
                         f"({src.shape[0]} source, {dst.shape[0]} "
                         "destination rows)")
    keep = keep_last(didx, active)
    sidx = np.where(keep, sidx, -1)
    didx = np.where(keep, didx, -1)
    snapshot = False
    if keep.any() and shares_storage(src, dst):
        same_rows = src.data_ptr() == dst.data_ptr() \
            and src.shape == dst.shape
        snapshot = (not same_rows) or bool(
            np.intersect1d(sidx[keep], didx[keep]).size)
    return sidx, didx, snapshot


def snapshot_rows(sidx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(unique active source rows, sidx remapped onto them; -1 stays)."""
    rows, inv = np.unique(sidx[sidx >= 0], return_inverse=True)
    out = np.full_like(sidx, -1)
    out[sidx >= 0] = inv
    return rows, out


def pad_bucket(src_idx, dst_idx, n_bucket: int) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """Pad both index streams with -1 to ``n_bucket`` entries."""
    sidx, didx = host_indices(src_idx), host_indices(dst_idx)
    n = sidx.size
    if n > n_bucket:
        raise ValueError(f"{n} descriptors exceed bucket {n_bucket}")
    pad = np.full(n_bucket - n, -1, np.int64)
    return np.concatenate([sidx, pad]), np.concatenate([didx, pad])


def device_i32(sidx: np.ndarray, didx: np.ndarray,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both index streams as int32 on ``device``, in one upload."""
    both = torch.from_numpy(np.stack([sidx, didx]).astype(np.int32))
    both = both.to(device)
    return both[0], both[1]


def stream_of(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream."""
    return raw_stream(torch.cuda.current_device() if device.index is None
                      else device.index)


def raw_stream(index: int) -> int:
    """The raw handle of the current CUDA stream of device ``index``
    (without building a ``torch.cuda.Stream``, which costs several µs)."""
    return torch._C._cuda_getCurrentRawStream(index)


#: The most descriptors one launch takes (``csrc/desc_table.cuh``).
MAX_TABLE = 4088
_I64 = np.dtype(np.int64)


def int64_streams(src_idx, dst_idx,
                  api: str) -> Tuple[np.ndarray, np.ndarray]:
    """Both index streams as contiguous int64 numpy arrays of one length;
    arrays that are that already pass through untouched."""
    sidx, didx = src_idx, dst_idx
    if not (type(sidx) is np.ndarray and sidx.dtype is _I64
            and sidx.ndim == 1 and sidx.flags.c_contiguous):
        sidx = np.ascontiguousarray(host_indices(sidx))
    if not (type(didx) is np.ndarray and didx.dtype is _I64
            and didx.ndim == 1 and didx.flags.c_contiguous):
        didx = np.ascontiguousarray(host_indices(didx))
    if sidx.shape != didx.shape:
        raise ValueError(f"{api}: {sidx.size} source vs {didx.size} "
                         "destination indices")
    return sidx, didx


def overlaps(src: torch.Tensor, dst: torch.Tensor) -> bool:
    """Whether the two pools' bytes overlap (a pointer comparison)."""
    a, b = src.data_ptr(), dst.data_ptr()
    return a < b + dst.nbytes and b < a + src.nbytes


def unaliased_source(src: torch.Tensor, dst: torch.Tensor, sidx: np.ndarray,
                     didx: np.ndarray, copy_rows) -> Tuple[torch.Tensor,
                                                           np.ndarray]:
    """``(src, sidx)`` for a launch into ``dst`` when the pools overlap:
    unchanged when no active source row can be overwritten by the call,
    else a scratch pool of the active source rows (filled by
    ``copy_rows(src, scratch, rows)``) and ``sidx`` remapped onto it.
    Active: both indices >= 0."""
    active = (sidx >= 0) & (didx >= 0)
    if not active.any():
        return src, sidx
    same_rows = src.data_ptr() == dst.data_ptr() and src.shape == dst.shape
    if same_rows and not np.intersect1d(sidx[active], didx[active]).size:
        return src, sidx
    rows, sidx = snapshot_rows(np.where(active, sidx, -1))
    scratch = torch.empty((rows.size, src.shape[1]), dtype=src.dtype,
                          device=src.device)
    copy_rows(src, scratch, rows)
    return scratch, sidx


# ---------------------------------------------------------------------------
# descriptor_copy
# ---------------------------------------------------------------------------

def descriptor_copy_plain(src_idx, dst_idx, src: torch.Tensor,
                          dst: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch :func:`descriptor_copy` (same rules, any device)."""
    check_pools(src, dst, "descriptor_copy_plain")
    sidx, didx, _ = prepare(src_idx, dst_idx, src, dst,
                            "descriptor_copy_plain")
    keep = sidx >= 0
    if keep.any():
        # The gather materializes the source rows before the scatter, which
        # is the snapshot rule.
        rows = src[torch.from_numpy(sidx[keep]).to(src.device)]
        dst[torch.from_numpy(didx[keep]).to(dst.device)] = rows
    return dst


def _launch_copy(src: torch.Tensor, dst: torch.Tensor, sidx: np.ndarray,
                 didx: np.ndarray) -> None:
    """One call into the library: range check, packing and the launches.
    ``sidx``/``didx``: contiguous int64 numpy arrays of one length, handed
    over as bytes (cheaper to pass than their addresses)."""
    launch_on_card("descriptor_copy", src, dst, sidx, didx)


def launch_on_card(name: str, src: torch.Tensor, dst: torch.Tensor,
                   sidx: np.ndarray, didx: np.ndarray, *extra) -> None:
    """Call copy kernel ``name``'s table launch function for ``dst``'s card
    on its current stream: the pools, their row counts, both streams'
    bytes, the count, the row width in bytes, then ``extra``."""
    args = (src.data_ptr(), dst.data_ptr(), src.shape[0], dst.shape[0],
            sidx.tobytes(), didx.tobytes(), sidx.size,
            src.shape[1] * src.element_size(), *extra)
    index = dst.get_device()
    if index == torch.cuda.current_device():
        launch_table(name, *args, raw_stream(index))
    else:
        with torch.cuda.device(index):
            launch_table(name, *args, raw_stream(index))


def _copy_rows(src: torch.Tensor, scratch: torch.Tensor,
               rows: np.ndarray) -> None:
    _launch_copy(src, scratch, rows, np.arange(rows.size))


def descriptor_copy(src_idx, dst_idx, src: torch.Tensor,
                    dst: torch.Tensor) -> torch.Tensor:
    """dst[dst_idx[i]] = src[src_idx[i]] for each descriptor i, in place.

    src/dst: (rows, unit) row pools of one dtype (any) on one device. An
    active index out of range raises ``IndexError`` before anything is
    written.
    """
    check_pools(src, dst, "descriptor_copy")
    if dst.get_device() < 0:                       # on the CPU
        return descriptor_copy_plain(src_idx, dst_idx, src, dst)
    refuse_grad("descriptor_copy", src, dst)
    sidx, didx = int64_streams(src_idx, dst_idx, "descriptor_copy")
    if overlaps(src, dst):
        src, sidx = unaliased_source(src, dst, sidx, didx, _copy_rows)
    _launch_copy(src, dst, sidx, didx)
    return dst


# ---------------------------------------------------------------------------
# Bucketed variant: one index-stream length per pow2 descriptor-count bucket.
# ---------------------------------------------------------------------------

def descriptor_copy_bucketed(src_idx, dst_idx, src: torch.Tensor,
                             dst: torch.Tensor, *,
                             n_bucket: int) -> torch.Tensor:
    """:func:`descriptor_copy` over index streams padded to ``n_bucket``.

    The translation cache (:mod:`repro_torch.runtime.lowering`) keys its
    artifacts on pow2 segment-count buckets; the ``-1`` padding keeps the
    TPU kernel's contract. The padding entries are skips, so on CUDA the
    streams are not padded (the launch drops -1 entries anyway); the CPU
    route pads, as the TPU kernel does. Raises ``ValueError`` when there
    are more than ``n_bucket`` descriptors.
    """
    if isinstance(dst, torch.Tensor) and dst.get_device() >= 0:  # a card
        sidx, didx = int64_streams(src_idx, dst_idx,
                                   "descriptor_copy_bucketed")
        if sidx.size > n_bucket:
            raise ValueError(f"{sidx.size} descriptors exceed bucket "
                             f"{n_bucket}")
    else:
        sidx, didx = pad_bucket(src_idx, dst_idx, n_bucket)
    return descriptor_copy(sidx, didx, src, dst)


# ---------------------------------------------------------------------------
# Chained variant: a linked list through the pointer-doubled permutation.
# ---------------------------------------------------------------------------

def chain_copy(descs, src: torch.Tensor, dst: torch.Tensor, *,
               head: int = 0) -> torch.Tensor:
    """Execute a DescriptorArray chain of row moves on the row pools."""
    from repro_torch.core.chain import flatten_chain

    perm, _ = flatten_chain(descs.nxt, head)
    perm = perm.to(torch.int64)
    order = perm.clamp_min(0)
    neg = torch.full_like(perm, -1)
    gathered_src = torch.where(perm >= 0, descs.src.to(torch.int64)[order],
                               neg)
    gathered_dst = torch.where(perm >= 0, descs.dst.to(torch.int64)[order],
                               neg)
    return descriptor_copy(gathered_src, gathered_dst, src, dst)
