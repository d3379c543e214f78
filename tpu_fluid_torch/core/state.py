"""Simulation state (`tpu_fluid.core.state`): the arrays that persist
across frames, with the field names, shapes and dtypes of the JAX
package's `FluidState`.

  velocity     (3, X, Y, Z) float32  staggered MAC velocities
  cell_types   (X, Y, Z)    uint8    CellType codes
  inertia      detailed grid, cfg.inertia_dtype (uint8, or int32 when
               max_inertia > 255)
  float_dens_1/2 detailed grid, float32 (the blur's ping-pong pair; both
               persist because cells under SOLID parents keep stale values)
  positions    (P, 3) float32        marker particle positions
  active       (P,)   bool           particle activity flag
  detailed_occ detailed grid, uint8  occupancy of the current positions
  step         ()     int32          frame counter
  dropped      ()     int32          particles lost to bounded capacity on
               the domain-sharded path; always 0 here

`state_to_numpy` and `state_from_numpy` carry a state between the two
packages through numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.types import CellType


class FluidState(NamedTuple):
    velocity: torch.Tensor
    cell_types: torch.Tensor
    inertia: torch.Tensor
    float_dens_1: torch.Tensor
    float_dens_2: torch.Tensor
    positions: torch.Tensor
    active: torch.Tensor
    detailed_occ: torch.Tensor
    step: torch.Tensor
    dropped: torch.Tensor


# A state of None fields: a step's `into` when the caller gives none, so
# that every field is allocated.
NOWHERE = FluidState(*(None,) * len(FluidState._fields))


def init_particles(cfg: FluidConfig, device=None):
    """Stage 00: spawn the initial particle blob(s)
    (`00_init_particles/init_particles.comp:27-49`).  Id i of a cube maps
    to cube index (i % rx, (i/rx) % ry, i/(rx*ry)) and position
    off + idx/res * size; cubes take consecutive id ranges and leftover ids
    stay inactive.  Id arithmetic runs in int64 (the JAX package uses
    uint32); ids below a cube's start are masked out either way."""
    p = cfg.particle_count
    cubes = [(cfg.particle_init_cube_resolution,
              cfg.particle_init_cube_offset,
              cfg.particle_init_cube_size)]
    cubes += list(cfg.extra_particle_cubes)

    ids = torch.arange(p, dtype=torch.int64, device=device)
    pos = torch.zeros((p, 3), dtype=torch.float32, device=device)
    active = torch.zeros((p,), dtype=torch.bool, device=device)
    start = 0
    for (rx, ry, rz), offset, size_ in cubes:
        vol = rx * ry * rz
        rel = ids - start
        x = rel % rx
        y = (rel // rx) % ry
        z = (rel // (rx * ry)) % rz
        idx = torch.stack([x, y, z], dim=-1).to(torch.float32)
        res = torch.tensor([rx, ry, rz], dtype=torch.float32, device=device)
        off = torch.tensor(offset, dtype=torch.float32, device=device)
        size = torch.tensor(size_, dtype=torch.float32, device=device)
        in_cube = (ids >= start) & (ids < start + vol)
        pos = torch.where(in_cube[:, None], off + idx / res * size, pos)
        active = active | in_cube
        start += vol
    return pos.to(cfg.torch_dtype), active


def initial_state(cfg: FluidConfig, device="cuda") -> FluidState:
    """Allocate and initialize all state on `device` (the card unless the
    caller passes "cpu"): zero velocities,
    INACTIVE cells, zero inertia and float fields, the spawned particles
    and their occupancy."""
    from tpu_fluid_torch.stages.particles import detailed_occupancy

    device = torch.device(device)
    gx, gy, gz = cfg.grid_size
    dsize = cfg.detailed_size
    dt = cfg.torch_dtype
    pos, active = init_particles(cfg, device)
    return FluidState(
        velocity=torch.zeros((3, gx, gy, gz), dtype=dt, device=device),
        cell_types=torch.full((gx, gy, gz), CellType.INACTIVE,
                              dtype=torch.uint8, device=device),
        inertia=torch.zeros(dsize, dtype=cfg.inertia_dtype, device=device),
        float_dens_1=torch.zeros(dsize, dtype=dt, device=device),
        float_dens_2=torch.zeros(dsize, dtype=dt, device=device),
        positions=pos,
        active=active,
        detailed_occ=detailed_occupancy(pos, active, cfg),
        step=torch.zeros((), dtype=torch.int32, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
    )


def state_to_numpy(state: FluidState) -> dict:
    """Field name -> numpy array, copied to the host."""
    return {name: value.detach().cpu().numpy()
            for name, value in state._asdict().items()}


def state_from_numpy(arrays: dict, device="cuda") -> FluidState:
    """A state on `device` (the card unless the caller passes "cpu") from
    numpy arrays keyed by field name (a JAX `FluidState`
    converts with `{k: np.asarray(v) for k, v in s._asdict().items()}`)."""
    device = torch.device(device)
    return FluidState(**{
        name: torch.from_numpy(np.array(arrays[name], order="C")).to(device)
        for name in FluidState._fields})
