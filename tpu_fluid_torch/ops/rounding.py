"""Correctly rounded f32 operations that PyTorch lacks or rounds otherwise.

XLA:CPU contracts a product and a sum of one fused loop into a fused
multiply-add, and its small dots accumulate by fused multiply-adds, so
matching the JAX package bitwise takes an `fma` (PyTorch has none), and
PyTorch's vectorized f32 `sqrt` on the CPU is not always correctly rounded
where XLA's is.  Both compute in f64 on any device, where the card's
`sqrt` and float conversion are IEEE as well.
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of f32 tensors with one rounding.  The product of two f32
    values is exact in f64; the f64 sum is rounded to odd (its last bit
    set where TwoSum finds an error), so that the rounding to f32 is the
    correct one and not a double rounding."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact = torch.isfinite(s) & (err != 0)
    # truncate toward zero, then set the last bit: round to odd
    toward_zero = torch.where((err > 0) == (s > 0), s,
                              torch.nextafter(s, torch.zeros_like(s)))
    odd = (toward_zero.view(torch.int64) | 1).view(torch.float64)
    return torch.where(inexact, odd, s).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE square root of an f32 tensor (through f64, which rounds once
    more without changing the result)."""
    return torch.sqrt(x.double()).float()
