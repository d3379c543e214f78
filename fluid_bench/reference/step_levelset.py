"""The plain reference of one step with the level-set surface
(`surface_method="levelset"`): stages 01-15 of `reference/step.py`, then,
in place of its stages 16-18, the level set rebuilt from the particles on
the detailed grid, in plain PyTorch.

The level set is a frozen copy of the program's plain one
(`surface/levelset.py`), kept here so that the judgement does not move
when the program does:

  1. phi = the chamfer distance (detailed cells) to the nearest occupied
     cell: 0 where occupied, else `BIG`, then `sweeps` passes of
     phi' = min(phi, min over the 26 neighbours of phi + w), the
     neighbours in `CHAMFER26` order with w = 1, sqrt 2, sqrt 3 for face,
     edge and corner steps (`BIG` outside the grid);
  2. f = iso - min(phi, sweeps + 1);
  3. `levelset_smooth` passes of f' = (f + the sum of the 6 neighbours in
     MOVES order, 0 outside) times the float32 reciprocal of 7, where
     cells under a SOLID sim cell keep their value.

The iso and the sweeps are derived from the configuration's fields as
the program's `FluidConfig` derives them (`Scene.levelset_iso_value`,
`Scene.levelset_sweeps_value`) where the fields leave them null.  The
inertia is carried through unchanged, and the field is returned as both
blur buffers.

`dtype` is the floating type every float field and every float stage
computes in, the level set's distance too: float32 is the configuration's
own precision, and the control runs it in bfloat16.  It imports nothing
of the program.  Options are those of `reference/step.py`'s `SUPPORTED`,
with the level set in place of the inertia surface; any other raises,
naming it (`Scene`).
"""

from __future__ import annotations

import numpy as np
import torch

from fluid_bench.reference import step as ref
from fluid_bench.reference.step import (FIELDS, FLOAT_FIELDS,  # noqa: F401
                                        MOVES, SOLID, shifted)

# the options this reference implements, and the value each must have
SUPPORTED = dict(ref.SUPPORTED, surface_method="levelset")
# the distance of a cell no sweep has reached
BIG = 1e6
# the 26 neighbours' offsets and chamfer weights, in the order the
# program takes their minimum
CHAMFER26 = tuple(
    ((dx, dy, dz), float((dx * dx + dy * dy + dz * dz) ** 0.5))
    for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    if (dx, dy, dz) != (0, 0, 0))
# a division by 7 as the program computes it: a product with the float32
# reciprocal
SEVENTH = float(np.float32(1.0) / np.float32(7.0))


class Scene(ref.Scene):
    """The configuration's numbers, read from its file's `fields`, and
    the level set's derived iso and sweeps."""

    def __init__(self, fields: dict):
        for key, want in SUPPORTED.items():
            if fields.get(key, want) != want:
                raise ValueError(f"reference: {key}={fields[key]!r} is not "
                                 f"implemented (only {want!r})")
        if fields.get("advect_method", "auto") not in ("auto", "pallas",
                                                       "shift"):
            raise ValueError("reference: only the shift advection")
        self.f = dict(fields)

    @property
    def target_density(self) -> float:
        """Particles a sim cell in the initial cubes."""
        cubes = [(self.particle_init_cube_resolution,
                  self.particle_init_cube_size)]
        cubes += [(res, size) for res, _off, size in
                  self.extra_particle_cubes]
        active, vol = 0, 0.0
        for res, size in cubes:
            active += res[0] * res[1] * res[2]
            vol += size[0] * size[1] * size[2]
        active = min(active, self.particle_count)
        return float(active) / max(vol, 1e-6)

    @property
    def levelset_iso_value(self) -> float:
        if self.levelset_iso is not None:
            return float(self.levelset_iso)
        spacing = (self.surface_render_resolution
                   / max(self.target_density, 1e-6) ** (1 / 3))
        return max(0.8, 1.2 * spacing)

    @property
    def levelset_sweeps_value(self) -> int:
        if self.levelset_sweeps is not None:
            return int(self.levelset_sweeps)
        return int(-(-self.levelset_iso_value // 1)) + 2


# ---------------------------------------------- stages 16-18: the level set
def chamfer(occ, sweeps: int, dtype):
    """The chamfer distance to the nearest occupied cell, exact up to
    `sweeps` steps, `BIG` beyond."""
    phi = torch.full(occ.shape, BIG, dtype=dtype, device=occ.device)
    phi.masked_fill_(occ != 0, 0.0)
    for _ in range(sweeps):
        nb = phi
        for mv, w in CHAMFER26:
            nb = torch.minimum(nb, shifted(phi, mv, fill=BIG) + w)
        phi = nb
    return phi


def levelset(types, occ, cfg: Scene, dtype):
    """The signed field on the detailed grid, positive inside."""
    sweeps = cfg.levelset_sweeps_value
    phi = chamfer(occ, sweeps, dtype)
    f = cfg.levelset_iso_value - torch.clamp(phi, max=sweeps + 1.0)
    if not cfg.levelset_smooth:
        return f
    skip = types == SOLID
    for ax in range(3):
        skip = torch.repeat_interleave(skip, cfg.surface_render_resolution,
                                       dim=ax)
    for _ in range(cfg.levelset_smooth):
        nsum = torch.zeros_like(f)
        for mv in MOVES:
            nsum = nsum + shifted(f, mv, fill=0.0)
        f = torch.where(skip, f, (f + nsum) * SEVENTH)
    return f


# ------------------------------------------------------------- the step
@torch.no_grad()
def step(state: dict, cfg: Scene, dtype=torch.float32) -> dict:
    """One frame from `state` (a dict of the program's fields): stages
    01-15 of `reference/step.py`, then the level set.  Float fields are
    cast to `dtype` first, and every float stage computes in it."""
    s = {k: (v.to(dtype) if k in FLOAT_FIELDS else v)
         for k, v in state.items()}
    old_types = s["cell_types"]
    types = ref.classify(ref.pool(s["detailed_occ"],
                                  cfg.surface_render_resolution), cfg)
    vel = ref.extrapolate(old_types, types, s["velocity"])
    vel = ref.advect(types, vel, cfg)
    vel = ref.apply_forces(types, vel, cfg)
    vel = ref.diffuse(types, vel, cfg)
    vel = ref.apply_solids(types, vel, cfg)
    p = ref.jacobi(types, ref.divergence(vel), cfg, dtype)
    vel = ref.project(types, p, vel, cfg)
    pos = ref.move_particles(vel, s["positions"], s["active"], cfg.dt)
    occ = ref.occupancy(pos, s["active"], cfg.surface_render_resolution,
                        cfg.detailed_size)
    f = levelset(types, occ, cfg, dtype)
    return {"velocity": vel, "cell_types": types, "inertia": s["inertia"],
            "float_dens_1": f, "float_dens_2": f, "positions": pos,
            "active": s["active"], "detailed_occ": occ,
            "step": s["step"] + 1, "dropped": s["dropped"]}
