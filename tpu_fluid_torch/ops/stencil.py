"""Shift/neighbor helpers for 6-point stencils (`tpu_fluid.ops.stencil`).

Out-of-grid reads take a fill value (0, or False for masks), the GLSL
robust-access zero of the reference shaders.
"""

from __future__ import annotations

import numpy as np
import torch

# Axis unit moves, same order as the reference's `moves[6]` tables and the
# JAX package's stencil sums.
MOVES = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0), (0, -1, 0), (0, 0, -1))

# The order the fused TPU kernels (and so the CUDA kernels) add the six
# neighbours in: x+1, x-1, y+1, y-1, z+1, z-1.
AXIS_MOVES = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
              (0, 0, -1))


def shifted(a: torch.Tensor, offset, fill=0) -> torch.Tensor:
    """out[i] = a[i + offset], `fill` outside the grid.  `offset` is a
    length-3 int tuple acting on the last three axes, so it serves (X,Y,Z)
    fields and (C,X,Y,Z) stacked components alike."""
    if all(off == 0 for off in offset):
        return a
    out = torch.full_like(a, fill)
    src = [slice(None)] * a.ndim
    dst = [slice(None)] * a.ndim
    for k, off in enumerate(offset):
        ax = a.ndim - 3 + k
        n = a.shape[ax]
        if abs(off) >= n:
            return out
        if off > 0:
            src[ax], dst[ax] = slice(off, n), slice(0, n - off)
        elif off < 0:
            src[ax], dst[ax] = slice(0, n + off), slice(-off, n)
    out[tuple(dst)] = a[tuple(src)]
    return out


def axis_nonzero(shape, c: int, device=None) -> torch.Tensor:
    """Mask of i_c != 0, broadcastable against an (X, Y, Z) field."""
    idx = torch.arange(shape[c], device=device)
    return (idx != 0).reshape(tuple(-1 if k == c else 1 for k in range(3)))


def div_scalar(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b with IEEE division on every device.  PyTorch's CUDA division
    by a Python number multiplies by its reciprocal instead, which can
    differ in the last bit from the JAX package and from the kernels.  The
    divisor is filled in on the device, never copied from the host, so the
    division can be captured in a CUDA graph."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def div_const(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b as the JAX package's jitted programs compute a division by a
    constant: XLA's algebraic simplifier turns it into a product with the
    f32 reciprocal of b, which can differ from the quotient in the last
    bit (`div_scalar` keeps the quotient)."""
    return a * float(np.float32(1.0) / np.float32(b))


def neighbor_sum(a: torch.Tensor, fill=0, moves=MOVES) -> torch.Tensor:
    """Sum of the 6 axis neighbours, `fill` outside the grid, added left to
    right in the order of `moves`."""
    out = None
    for mv in moves:
        s = shifted(a, mv, fill=fill)
        out = s if out is None else out + s
    return out
