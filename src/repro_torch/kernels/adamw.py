"""AdamW's update of one leaf and the sum of squares of a tree's leaves.

``adamw_update(p, g, m, v, scale, lr, b1c, b2c, *, b1, b2, eps,
weight_decay)`` runs one AdamW step over a leaf in place: ``p`` its
parameters, ``g`` their gradient (any layout of ``p``'s size), ``m`` and
``v`` its fp32 moments; ``scale`` (the clip), ``lr`` and the bias
corrections ``b1c``, ``b2c`` are 0-d fp32 tensors on the leaf's device,
the rest the optimizer's Python floats. Weight decay is added to the step
(``delta += weight_decay * p``), as in the reference, not taken off ``p``.

``sum_squares(xs)`` is the fp32 sum of the squares of every element of
the tensors ``xs``, each read in its own dtype: a 0-d fp32 tensor on their
device. The optimizer's global norm is its square root.

On the card each launches ``csrc/adamw.cu``: the update once a leaf (bit
for bit the plain version's result), the sum once a leaf and once more
for the tree (in a fixed order, so repeated calls give the same bits; in
another order than ``torch.dot``, so it may differ from the plain
version in its last bits). The update takes fp32 parameters with fp32
gradients, and bf16 parameters with bf16 or fp32 gradients, ``p``, ``m``
and ``v`` contiguous; anything else raises. On the CPU (and the meta
device) each runs its plain version, the eager PyTorch body, which takes
any dtype and layout.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .build import launch, plain_device
from .descriptor_copy import stream_of

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: The (parameter, gradient) dtypes the update kernel takes.
UPDATE_PAIRS = ((torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.float32))
#: ``csrc/adamw.cu``'s threads a block, elements a vector step and largest
#: grid: a leaf of n elements takes ceil(n / 2048) blocks, at most 1,056.
_THREADS, _VEC, _MAX_BLOCKS = 256, 8, 132 * 8


def adamw_update_plain(p, g, m, v, scale, lr, b1c, b2c, *, b1: float,
                       b2: float, eps: float, weight_decay: float) -> None:
    """The eager body of :func:`adamw_update` (any device, dtype, layout)."""
    g = g.reshape(p.shape).float() * scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g.square_())
    del g
    delta = (m / b1c).div_((v / b2c).sqrt_().add_(eps))
    if weight_decay:
        delta.add_(weight_decay * p.float())
    if p.dtype == torch.float32:
        p.sub_(lr * delta)
    else:
        p.copy_((p.float() - lr * delta).to(p.dtype))


def check_update(p, g, m, v, *scalars) -> None:
    """Raise unless the update kernel takes these tensors: a dtype pair of
    :data:`UPDATE_PAIRS`, fp32 moments, ``p``, ``m`` and ``v`` contiguous
    and of one shape, ``g`` of their size, the scalars 0-d fp32 tensors,
    all on one device."""
    if (p.dtype, g.dtype) not in UPDATE_PAIRS:
        raise TypeError(f"adamw_update: parameters {p.dtype} with gradients "
                        f"{g.dtype} not supported (float32/float32, "
                        "bfloat16/bfloat16, bfloat16/float32)")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"adamw_update: moments {m.dtype}, {v.dtype}; "
                        "float32 expected")
    if not p.shape == m.shape == v.shape or g.numel() != p.numel():
        raise ValueError(f"adamw_update: shapes p {tuple(p.shape)}, "
                         f"g {tuple(g.shape)}, m {tuple(m.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    for name, t in (("p", p), ("m", m), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"adamw_update: {name} is not contiguous")
    for t in scalars:
        if t.numel() != 1 or t.dtype != torch.float32:
            raise TypeError("adamw_update: scale, lr, b1c and b2c must be "
                            "one-element float32 tensors")
    if any(t.device != p.device for t in (g, m, v, *scalars)):
        raise ValueError("adamw_update: tensors on more than one device")


def adamw_update(p, g, m, v, scale, lr, b1c, b2c, *, b1: float, b2: float,
                 eps: float, weight_decay: float) -> None:
    """One AdamW step over the leaf ``p``, ``m`` and ``v``, in place (see
    the module's docstring): the kernel for CUDA tensors, the plain
    version for CPU ones."""
    if plain_device(p):
        adamw_update_plain(p, g, m, v, scale, lr, b1c, b2c, b1=b1, b2=b2,
                           eps=eps, weight_decay=weight_decay)
        return
    check_update(p, g, m, v, scale, lr, b1c, b2c)
    if p.numel() == 0:
        return
    g = g.reshape(-1)
    with torch.cuda.device(p.device):
        launch("adamw_update", p.data_ptr(), g.data_ptr(), m.data_ptr(),
               v.data_ptr(), p.numel(), _DTYPE_CODE[p.dtype],
               _DTYPE_CODE[g.dtype], scale.data_ptr(), lr.data_ptr(),
               b1c.data_ptr(), b2c.data_ptr(), float(b1), float(b2),
               float(eps), float(weight_decay), stream_of(p.device))


def sum_squares_plain(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The eager :func:`sum_squares`: an fp32 ``dot`` a tensor, summed."""
    flat = [x.reshape(-1).float() for x in xs]
    return torch.stack([torch.dot(f, f) for f in flat]).sum()


def blocks(n: int) -> int:
    """The blocks, each writing one partial sum, that the first stage of
    :func:`sum_squares` gives a tensor of ``n`` elements."""
    return max(1, min(-(-n // (_THREADS * _VEC)), _MAX_BLOCKS))


def sum_squares(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fp32 sum of squares of every element of ``xs`` (see the
    module's docstring): on the card one launch a non-empty tensor and one
    for the sum of their partial sums."""
    xs = list(xs)
    if plain_device(xs[0]):
        return sum_squares_plain(xs)
    dev = xs[0].device
    for x in xs:
        if x.dtype not in _DTYPE_CODE:
            raise TypeError(f"sum_squares: dtype {x.dtype} not supported "
                            "(float32 or bfloat16)")
        if x.device != dev:
            raise ValueError("sum_squares: tensors on more than one device")
    flat = [x.reshape(-1) for x in xs if x.numel()]
    n_blocks = [blocks(x.numel()) for x in flat]
    partial = torch.empty(sum(n_blocks), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    at = partial.data_ptr()
    with torch.cuda.device(dev):
        stream = stream_of(dev)
        for x, b in zip(flat, n_blocks):
            launch("sum_squares", x.data_ptr(), x.numel(),
                   _DTYPE_CODE[x.dtype], 1, at, b, stream)
            at += 4 * b
        launch("sum_squares", partial.data_ptr(), partial.numel(), 0, 0,
               out.data_ptr(), 1, stream)
    return out
