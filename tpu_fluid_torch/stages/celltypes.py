"""Cell classification stages 02, 03 and 06 (`tpu_fluid.stages.celltypes`;
reference `02_update_water`, `03_update_air`, `06_update_cell_types`)."""

from __future__ import annotations

import torch

from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.ops.stencil import MOVES, shifted


def update_water(densities: torch.Tensor) -> torch.Tensor:
    """Stage 02: cells with >0 particles are WATER, the rest INACTIVE."""
    return torch.where(densities > 0, CellType.WATER,
                       CellType.INACTIVE).to(torch.uint8)


def solid_mask(shape, cfg=None, device=None, x0: int = 0,
               global_gx: int | None = None) -> torch.Tensor:
    """Static solid cells: the domain border plus any configured obstacle
    boxes.  On an x-slab, `x0` is the global x of its row 0 and
    `global_gx` the domain's x extent."""
    lx, gy, gz = shape
    gx = lx if global_gx is None else global_gx
    ix = torch.arange(x0, x0 + lx, device=device)[:, None, None]
    iy = torch.arange(gy, device=device)[None, :, None]
    iz = torch.arange(gz, device=device)[None, None, :]
    mask = ((ix == 0) | (ix == gx - 1) | (iy == 0) | (iy == gy - 1)
            | (iz == 0) | (iz == gz - 1))
    if cfg is not None:
        for (x0, y0, z0), (x1, y1, z1) in cfg.solid_boxes:
            mask = mask | ((ix >= x0) & (ix < x1) & (iy >= y0) & (iy < y1)
                           & (iz >= z0) & (iz < z1))
    return mask


def update_air(types: torch.Tensor, cfg=None, x0: int = 0,
               global_gx: int | None = None,
               extra_solid: torch.Tensor | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Stage 03: static solid cells become SOLID; non-water cells with at
    least one WATER neighbour become AIR (neighbours read from the stage-02
    output, which resolves the reference's in-place race
    deterministically).  `x0` and `global_gx` place an x-slab in the
    domain, as for `solid_mask`.  `extra_solid` (a scene's solid mask, of
    the same shape as `types`) makes its nonzero cells SOLID too.  The
    result is written into `out` where given."""
    solid = solid_mask(types.shape, cfg, types.device, x0, global_gx)
    if extra_solid is not None:
        solid = solid | (extra_solid != 0)
    water = types == CellType.WATER
    water_around = torch.zeros_like(water)
    for mv in MOVES:
        water_around = water_around | shifted(water, mv, fill=False)
    air = (~water) & water_around
    wet = torch.where(air, torch.full_like(types, CellType.AIR), types)
    return torch.where(solid, torch.full_like(types, CellType.SOLID), wet,
                       out=out)


def commit_cell_types(new_types: torch.Tensor) -> torch.Tensor:
    """Stage 06: NEW_CELL_TYPES -> CELL_TYPES copy; a no-op functionally."""
    return new_types
