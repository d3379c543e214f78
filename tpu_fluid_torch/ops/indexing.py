"""Float to integer conversion as the JAX package gets it from XLA.

`jnp.floor(p).astype(jnp.int32)` and `jnp.trunc(p).astype(jnp.int32)` turn
a NaN into 0 and saturate values beyond the integer type at its bounds.
PyTorch's `.to(torch.int64)` leaves those cases to the hardware: x86 gives
the type's minimum for every one of them, the card saturates.  Where the
JAX package's index math can meet a NaN, an infinite or a huge coordinate,
the port converts through `float_to_index`, so that it lands where JAX puts
it on either device.
"""

from __future__ import annotations

import torch


def float_to_index(x: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    """`x` (already floored or truncated) as `dtype`: toward zero, a NaN
    as 0, and values at or beyond the type's range as its nearest bound."""
    info = torch.iinfo(dtype)
    limit = 2.0 ** (info.bits - 1)
    big = x >= limit
    small = x < -limit
    inside = torch.where(big | small | torch.isnan(x), 0.0, x).to(dtype)
    return torch.where(big, info.max, torch.where(small, info.min, inside))
