"""Staggered trilinear velocity sampling (`tpu_fluid.ops.sampling`).

GLSL `texture()` with clamp-to-edge maps normalized coordinate u to texel
space t = u*N - 0.5, so the staggered sample point of component c at world
position p is the texel coordinate `p - 0.5 + 0.5*e_c`.
"""

from __future__ import annotations

import torch


def trilinear(field: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Trilinear clamp-to-edge sample of `field` (X,Y,Z) at texel coords
    `t` (..., 3): at or outside the border both lerp endpoints collapse to
    the edge texel."""
    i0f = torch.floor(t)
    w = t - i0f
    i0i = i0f.to(torch.int64)
    i0 = [torch.clamp(i0i[..., d], 0, field.shape[d] - 1) for d in range(3)]
    i1 = [torch.clamp(i0i[..., d] + 1, 0, field.shape[d] - 1)
          for d in range(3)]
    x0, y0, z0 = i0
    x1, y1, z1 = i1
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]

    c000 = field[x0, y0, z0]
    c100 = field[x1, y0, z0]
    c010 = field[x0, y1, z0]
    c110 = field[x1, y1, z0]
    c001 = field[x0, y0, z1]
    c101 = field[x1, y0, z1]
    c011 = field[x0, y1, z1]
    c111 = field[x1, y1, z1]

    c00 = c000 * (1 - wx) + c100 * wx
    c10 = c010 * (1 - wx) + c110 * wx
    c01 = c001 * (1 - wx) + c101 * wx
    c11 = c011 * (1 - wx) + c111 * wx
    c0 = c00 * (1 - wy) + c10 * wy
    c1 = c01 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


def velocity_component_at(vel: torch.Tensor, pos: torch.Tensor,
                          comp: int) -> torch.Tensor:
    """Sample staggered component `comp` of `vel` (3,X,Y,Z) at world
    positions `pos` (...,3): texel coords = pos - 0.5 + 0.5*e_comp."""
    half = torch.zeros(3, dtype=pos.dtype, device=pos.device)
    half[comp].fill_(0.5)         # no host scalar: capturable
    return trilinear(vel[comp], pos - 0.5 + half)


def velocity_at(vel: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The full staggered velocity vector at positions `pos` (...,3)."""
    return torch.stack(
        [velocity_component_at(vel, pos, c) for c in range(3)], dim=-1)
