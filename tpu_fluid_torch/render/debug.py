"""Debug data visualization (`tpu_fluid.render.debug`) — the reference's
disabled pipeline 32 (`32_debug_display_data/display_data.vert:25-33`,
toggled off at `fluid_flow_sections.h:474`): one point per sim cell,
colored blue -> red by log(density + 1) / 8.  Here it renders any per-cell
scalar field through the splat renderer, on the field's device."""

from __future__ import annotations

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.render.splat import (INF_DEPTH, _f32, project,
                                          splat_color, splat_depth)


def render_cell_field(field: torch.Tensor, mvp, cfg: FluidConfig,
                      width: int = 512, height: int = 512,
                      log_scale: bool = True) -> torch.Tensor:
    """field: (X, Y, Z) scalar (e.g. particle densities, pressure).
    Blue -> red colormap on log(field+1)/8 like the reference, or linear.
    Returns (H, W, 3) uint8."""
    device = field.device
    gx, gy, gz = field.shape
    ix, iy, iz = torch.meshgrid(torch.arange(gx, device=device),
                                torch.arange(gy, device=device),
                                torch.arange(gz, device=device),
                                indexing="ij")
    centers = torch.stack([ix, iy, iz], dim=-1).reshape(-1, 3) + 0.5
    vals = field.reshape(-1).to(torch.float32)
    if log_scale:
        t = torch.clamp(torch.log(torch.clamp(vals, min=0) + 1.0) / 8.0,
                        0.0, 1.0)
    else:
        lo, hi = vals.min(), vals.max()
        t = (vals - lo) / torch.clamp(hi - lo, min=1e-20)
    color = torch.stack([t, torch.zeros_like(t), 1.0 - t], dim=-1)
    show = vals > 0 if log_scale else torch.ones_like(vals, dtype=torch.bool)

    px, py, d, front = project(_f32(mvp, device), centers.to(torch.float32),
                               width, height)
    valid = show & front
    depth = torch.full((width * height,), INF_DEPTH, dtype=torch.float32,
                       device=device)
    depth = splat_depth(depth, px, py, d, valid, width, height)
    cbuf = torch.zeros((width * height,), dtype=torch.int32, device=device)
    cbuf = splat_color(cbuf, depth, px, py, d, color, valid, width, height)

    hit = ((cbuf >> 30) & 1) == 1
    img = torch.stack([torch.where(hit, (cbuf >> 16) & 0xFF, 0),
                       torch.where(hit, (cbuf >> 8) & 0xFF, 0),
                       torch.where(hit, cbuf & 0xFF, 0)], dim=-1)
    return img.to(torch.uint8).reshape(height, width, 3)
