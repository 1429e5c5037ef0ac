"""The benchmark's weights: drawn on the device from the seed, one large
call a group (the embedding; each block; the final norm), in the dtype
the configuration keeps them in. A group can be drawn again alone, the
same to the bit, so the weights a run started from can be had back
without keeping a copy.

Matrices are a truncated normal on [-2, 2] times ``fan_in ** -0.5`` (an
expert stack's fan_in is its second axis; a 3-D projection's, all axes
but the last; ``wo``'s its two leading axes), the embedding 0.02 times
it; norm scales and biases start at zero. The leaves are laid out as the
program's parameter tree has them (``shapes``, a dict from path to the
shape and dtype of each leaf), views of their group's buffer.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch


def derive_seed(seed: int, *parts) -> int:
    """A 63-bit seed for the stream named ``parts`` of run ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def group_of(path: str) -> str:
    """The group of a leaf: its block (``stack/slots/<j>/<i>``,
    ``stack/prefix/<i>``) or its top-level key."""
    parts = path.split("/")
    if parts[0] == "stack":
        return "/".join(parts[:4] if parts[1] == "slots" else parts[:3])
    return parts[0]


def _scale(path: str, shape) -> float:
    """The factor a leaf's unit draw is multiplied by; 0 for a leaf that
    starts at zero (norm scales and biases)."""
    name = path.rsplit("/", 1)[-1]
    if len(shape) < 2 or name in ("bq", "bk", "bv"):
        return 0.0
    if name == "embedding":
        return 0.02
    if len(shape) == 3 and "/ffn/" in path:      # (experts, in, out)
        fan_in = shape[1]
    elif name == "wo":                           # (heads, head_dim, d)
        fan_in = shape[0] * shape[1]
    else:
        fan_in = math.prod(shape[:-1])
    return fan_in ** -0.5


def draw_group(seed: int, group: str, shapes: Dict[str, Tuple],
               device) -> Dict[str, torch.Tensor]:
    """The leaves of one group: {path: tensor}, from one draw."""
    paths = [p for p in shapes if group_of(p) == group]
    sizes = [math.prod(shapes[p][0]) for p in paths]
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, "weights", group))
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, off = {}, 0
    views = []
    for p, n in zip(paths, sizes):
        view = flat[off:off + n]
        view.mul_(_scale(p, shapes[p][0]))
        views.append((p, off, n))
        off += n
    # One buffer a dtype, the leaves views of it.
    for dtype in {shapes[p][1] for p in paths}:
        sel = [(p, o, n) for p, o, n in views if shapes[p][1] == dtype]
        total = sum(n for _, _, n in sel)
        buf = torch.empty(total, dtype=dtype, device=device)
        at = 0
        for p, o, n in sel:
            buf[at:at + n].copy_(flat[o:o + n])
            out[p] = buf[at:at + n].view(shapes[p][0])
            at += n
    del flat
    return out


def groups(shapes: Dict[str, Tuple]) -> list:
    """The groups of a tree, in the order their leaves come."""
    seen = {}
    for p in shapes:
        seen.setdefault(group_of(p), None)
    return list(seen)


def draw(seed: int, shapes: Dict[str, Tuple], device) -> Dict[str, torch.Tensor]:
    """Every leaf of the tree ``shapes``: {path: tensor}."""
    out = {}
    for g in groups(shapes):
        out.update(draw_group(seed, g, shapes, device))
    return out
