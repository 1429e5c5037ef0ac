"""The paper's 256-bit transfer descriptor (Listing 1) — canonical formats.

Two representations, round-trippable:

1. **Packed host form** — bit-exact with the paper's Listing 1::

       struct descriptor {          // 32 bytes, little-endian
           u32 length;              // transfer length in bytes (<= 4 GiB)
           u32 config;              // front-/backend configuration bits
           u64 next;                // byte address of next descriptor, -1 = end
           u64 source;              // byte address of source
           u64 destination;         // byte address of destination
       }

   Stored as a numpy structured array; identical bytes to the JAX
   package's packed form.

2. **SoA form** (:class:`DescriptorArray`) — a struct-of-arrays of int32
   *element offsets* into named (src_pool, dst_pool) tensors. The fields
   are int32 **CPU** tensors: descriptors are host-side control state, as
   the paper's descriptors live in system memory. A drain copies the index
   streams it needs to the pool's device. ``next`` holds the *index* of
   the successor descriptor (-1 = end-of-chain).

Completion tracking follows §II-D: the engine overwrites the first 8 bytes of
a completed descriptor with all-ones (``DONE_SENTINEL``); in the SoA form this
is a ``done`` flag vector plus the same sentinel written into (length, config).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Constants (paper §II-B / §II-D)
# ---------------------------------------------------------------------------

DESCRIPTOR_BYTES = 32              # 256-bit descriptor
END_OF_CHAIN = np.uint64(0xFFFF_FFFF_FFFF_FFFF)   # `next` == -1 terminates
END_OF_CHAIN_IDX = np.int32(-1)    # device-side successor index sentinel
DONE_SENTINEL32 = np.uint32(0xFFFF_FFFF)          # first 8 B overwritten on done
MAX_TRANSFER_BYTES = 2**32 - 1     # u32 length field -> individual <= 4 GiB

# config field bit layout (frontend low half / backend high half)
CONFIG_IRQ_ENABLE = np.uint32(1 << 0)       # raise IRQ / completion event
CONFIG_WRITEBACK = np.uint32(1 << 1)        # overwrite first 8 B on completion
CONFIG_DECOUPLE_RW = np.uint32(1 << 2)      # backend: decouple R/W channels
CONFIG_SRC_FIXED = np.uint32(1 << 8)        # backend: fixed-address source
CONFIG_DST_FIXED = np.uint32(1 << 9)        # backend: fixed-address destination
CONFIG_BURST_SHIFT = 16                      # backend: max AXI burst length

PACKED_DTYPE = np.dtype(
    [
        ("length", "<u4"),
        ("config", "<u4"),
        ("next", "<u8"),
        ("source", "<u8"),
        ("destination", "<u8"),
    ]
)
assert PACKED_DTYPE.itemsize == DESCRIPTOR_BYTES


# ---------------------------------------------------------------------------
# Packed host form
# ---------------------------------------------------------------------------

def pack(
    length: Sequence[int],
    config: Sequence[int],
    next_addr: Sequence[int],
    source: Sequence[int],
    destination: Sequence[int],
) -> np.ndarray:
    """Build a packed descriptor table (numpy structured array)."""
    length = np.asarray(length, dtype=np.uint64)
    if np.any(length > MAX_TRANSFER_BYTES):
        raise ValueError("descriptor length exceeds u32 field (4 GiB); chain instead")
    out = np.zeros(len(length), dtype=PACKED_DTYPE)
    out["length"] = length.astype(np.uint32)
    out["config"] = np.asarray(config, dtype=np.uint32)
    out["next"] = np.asarray(next_addr, dtype=np.uint64)
    out["source"] = np.asarray(source, dtype=np.uint64)
    out["destination"] = np.asarray(destination, dtype=np.uint64)
    return out


def to_bytes(table: np.ndarray) -> bytes:
    """Serialize a packed table to the exact 32 B/descriptor wire layout."""
    return table.astype(PACKED_DTYPE, copy=False).tobytes()


def from_bytes(raw: bytes) -> np.ndarray:
    if len(raw) % DESCRIPTOR_BYTES:
        raise ValueError(f"raw length {len(raw)} not a multiple of {DESCRIPTOR_BYTES}")
    return np.frombuffer(raw, dtype=PACKED_DTYPE).copy()


def mark_done_packed(table: np.ndarray, idx: int) -> None:
    """§II-D completion writeback: first 8 bytes -> all ones."""
    table["length"][idx] = DONE_SENTINEL32
    table["config"][idx] = DONE_SENTINEL32


def is_done_packed(table: np.ndarray) -> np.ndarray:
    return (table["length"] == DONE_SENTINEL32) & (table["config"] == DONE_SENTINEL32)


# ---------------------------------------------------------------------------
# SoA form (int32 CPU tensors)
# ---------------------------------------------------------------------------

def as_i32(x) -> torch.Tensor:
    """Any integer sequence as an int32 CPU tensor (wrapping like a cast)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").to(torch.int32)
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(x).astype(np.int32)))


@dataclasses.dataclass
class DescriptorArray:
    """Struct-of-arrays descriptor table, host-side.

    All fields are int32 CPU tensors of equal length N:
      src    — element offset into the source pool
      dst    — element offset into the destination pool
      length — transfer length in *elements*
      nxt    — successor descriptor index (-1 = end-of-chain)
      config — config bits (same layout as packed form, truncated to 31 bits)
      done   — completion flag (0/1); sentinel mirror of the 8-byte writeback
    """

    src: torch.Tensor
    dst: torch.Tensor
    length: torch.Tensor
    nxt: torch.Tensor
    config: torch.Tensor
    done: torch.Tensor

    # -- constructors -------------------------------------------------------
    @classmethod
    def create(cls, src, dst, length, nxt=None, config=None) -> "DescriptorArray":
        src = as_i32(src)
        dst = as_i32(dst)
        length = as_i32(length)
        n = src.shape[0]
        if nxt is None:  # default: sequential chain ending at -1
            nxt = torch.cat([torch.arange(1, n, dtype=torch.int32),
                             torch.full((1,), -1, dtype=torch.int32)])
        else:
            nxt = as_i32(nxt)
        if config is None:
            config = torch.zeros((n,), dtype=torch.int32)
        else:
            config = as_i32(config)
        done = torch.zeros((n,), dtype=torch.int32)
        return cls(src, dst, length, nxt, config, done)

    @property
    def num_descriptors(self) -> int:
        return int(self.src.shape[0])

    def mark_done(self, idx) -> "DescriptorArray":
        """Host analogue of the all-ones writeback (returns a new table)."""
        idx = torch.as_tensor(np.asarray(idx, np.int64))
        done, length, config = (self.done.clone(), self.length.clone(),
                                self.config.clone())
        done[idx] = 1
        length[idx] = -1
        config[idx] = -1
        return dataclasses.replace(self, done=done, length=length,
                                   config=config)

    def all_done(self) -> bool:
        return bool(torch.all(self.done == 1))


def to_packed(
    d: DescriptorArray,
    *,
    elem_bytes: int = 1,
    src_base: int = 0,
    dst_base: int = 0,
    table_base: int = 0,
) -> np.ndarray:
    """Lower an SoA table to the packed 256-bit host layout.

    Element offsets become byte addresses relative to the given pool bases;
    successor indices become byte addresses of descriptor slots (sequential
    layout at ``table_base``), matching the planner in
    :mod:`repro_torch.core.chain`.
    """
    src = np.asarray(d.src, np.int64) * elem_bytes + src_base
    dst = np.asarray(d.dst, np.int64) * elem_bytes + dst_base
    length = np.asarray(d.length, np.int64) * elem_bytes
    nxt_idx = np.asarray(d.nxt, np.int64)
    nxt = np.where(
        nxt_idx < 0,
        np.int64(-1),
        table_base + nxt_idx * DESCRIPTOR_BYTES,
    ).astype(np.int64)
    cfg = np.asarray(d.config, np.int64) & 0xFFFF_FFFF
    tab = pack(
        np.where(np.asarray(d.done) == 1, 0, length),  # repacked done entries reset below
        cfg,
        nxt.astype(np.uint64),
        src.astype(np.uint64),
        dst.astype(np.uint64),
    )
    done = np.asarray(d.done) == 1
    for i in np.nonzero(done)[0]:
        mark_done_packed(tab, int(i))
    return tab


def from_packed(
    table: np.ndarray,
    *,
    elem_bytes: int = 1,
    src_base: int = 0,
    dst_base: int = 0,
    table_base: int = 0,
) -> DescriptorArray:
    """Inverse of :func:`to_packed` (requires aligned addresses)."""
    src = (table["source"].astype(np.int64) - src_base) // elem_bytes
    dst = (table["destination"].astype(np.int64) - dst_base) // elem_bytes
    done = is_done_packed(table)
    length = np.where(done, -1, table["length"].astype(np.int64) // elem_bytes)
    nxt_raw = table["next"]
    nxt = np.where(
        nxt_raw == END_OF_CHAIN,
        np.int64(-1),
        (nxt_raw.astype(np.int64) - table_base) // DESCRIPTOR_BYTES,
    )
    config = np.where(done, -1, table["config"].astype(np.int64))
    d = DescriptorArray.create(src, dst, length, nxt, config)
    return dataclasses.replace(d, done=as_i32(done))
