"""Scene fields (`tpu_fluid.core.scene_fields`): a per-cell solid mask and
a per-cell force field, passed beside the state to `step`, `jit_step`,
`jit_multi_step` and the x-slab step, rather than fixed in the config.

  solid  (X, Y, Z) bool or uint8 — nonzero cells become SOLID in stage 03,
         like the border and box rule (`update_active.comp:49-52`); the
         stage-10 repel rules then apply to them.
  force  (3, X, Y, Z) float32 — component c is added, times dt, to the
         cell's face c in stage 08 wherever the cell or its lower-c
         neighbour is WATER, the wetness rule of gravity
         (`forces.comp:33-44`).

The helpers build the arrays in numpy, as the JAX package does, and return
tensors on the card unless the caller passes `device="cpu"`.  The x-slab
step takes each shard's slabs (`parallel/mesh.shard_scene`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_fluid_torch.core.config import FluidConfig


class SceneFields(NamedTuple):
    solid: Optional[torch.Tensor] = None   # (X, Y, Z) uint8 or bool
    force: Optional[torch.Tensor] = None   # (3, X, Y, Z) float32

    def validate(self, cfg: FluidConfig) -> "SceneFields":
        g = tuple(cfg.grid_size)
        if self.solid is not None and tuple(self.solid.shape) != g:
            raise ValueError(f"scene solid shape {tuple(self.solid.shape)} "
                             f"!= grid {g}")
        if self.force is not None and tuple(self.force.shape) != (3,) + g:
            raise ValueError(f"scene force shape {tuple(self.force.shape)} "
                             f"!= (3, *{g})")
        return self


def solid_sphere(cfg: FluidConfig, center, radius,
                 device="cuda") -> torch.Tensor:
    """A spherical obstacle as an (X, Y, Z) uint8 solid mask."""
    gx, gy, gz = cfg.grid_size
    ix = np.arange(gx)[:, None, None]
    iy = np.arange(gy)[None, :, None]
    iz = np.arange(gz)[None, None, :]
    cx, cy, cz = center
    d2 = (ix - cx) ** 2 + (iy - cy) ** 2 + (iz - cz) ** 2
    return torch.from_numpy((d2 <= radius * radius).astype(np.uint8)).to(
        device)


def uniform_force(cfg: FluidConfig, vector, device="cuda") -> torch.Tensor:
    """A constant force field (wind, say) as (3, X, Y, Z) float32."""
    f = np.zeros((3,) + tuple(cfg.grid_size), np.float32)
    for c in range(3):
        f[c] = float(vector[c])
    return torch.from_numpy(f).to(device)


def vortex_force(cfg: FluidConfig, center_xz, strength,
                 device="cuda") -> torch.Tensor:
    """A force field circling the y axis through `center_xz`."""
    gx, gy, gz = cfg.grid_size
    ix = np.arange(gx)[:, None, None] - center_xz[0]
    iz = np.arange(gz)[None, None, :] - center_xz[1]
    r2 = np.maximum(ix ** 2 + iz ** 2, 1.0)
    f = np.zeros((3, gx, gy, gz), np.float32)
    f[0] = -iz / r2 * strength
    f[2] = ix / r2 * strength
    return torch.from_numpy(f).to(device)
