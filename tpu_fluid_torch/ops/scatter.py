"""Particle-to-grid histogram (`tpu_fluid.ops.scatter`).

The reference's integer-atomic scatter kernels
(`01_update_densities/update_densities.comp:29-36`,
`15_update_detailed_densities/update_detailed_densities.comp:24-32`) count
particles per cell.  Here an int32 `index_add_`: integer adds give the same
counts in any order, on the CPU and on the card.

The cell index is the truncated position (GLSL `ivec3(pos)`), converted as
XLA converts (`ops/indexing.float_to_index`): a NaN coordinate lands on
index 0 and an infinite or huge one saturates out of the grid.  Inactive and
out-of-grid particles add 0 at index 0.
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.ops.indexing import float_to_index


def particle_cell_histogram(positions: torch.Tensor, active: torch.Tensor,
                            grid_size, scale: float = 1.0) -> torch.Tensor:
    """(X, Y, Z) int32 count of the active particles in each cell.

    positions: (P, 3) float; active: (P,) bool; grid_size: (X, Y, Z).
    `scale` multiplies the positions before truncation (the detailed
    resolution for the surface grid, 1 for the sim grid)."""
    gx, gy, gz = grid_size
    p = positions if scale == 1.0 else positions * scale
    idx = float_to_index(torch.trunc(p), torch.int32).to(torch.int64)
    x, y, z = idx[:, 0], idx[:, 1], idx[:, 2]
    inb = ((x >= 0) & (x < gx) & (y >= 0) & (y < gy) & (z >= 0) & (z < gz)
           & active)
    flat = torch.where(inb, x * (gy * gz) + y * gz + z, 0)
    counts = torch.zeros(gx * gy * gz, dtype=torch.int32,
                         device=positions.device)
    counts.index_add_(0, flat, inb.to(torch.int32))
    return counts.reshape(gx, gy, gz)
