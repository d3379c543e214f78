"""Velocity-field stages: extrapolation (04/05), advection (07), forces
(08), diffusion (09), solid handling (10) (`tpu_fluid.stages.velocity`).

All fields are (3, X, Y, Z) staggered MAC velocities; component c of cell i
lives on the lower face of i in dim c.
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.kernels import kernel_choice
from tpu_fluid_torch.kernels.advect import (advect_all_cuda,
                                            advect_condition,
                                            advect_conditions,
                                            advect_slab_plain,
                                            face_center_velocity)
from tpu_fluid_torch.ops.sampling import velocity_at, velocity_component_at
from tpu_fluid_torch.ops.stencil import MOVES, axis_nonzero, shifted

__all__ = [
    "compute_extrapolated_velocities", "set_extrapolated_velocities",
    "face_center_velocity", "advect_gather", "advect_shift", "advect",
    "apply_forces", "diffuse", "apply_solids",
]


def _is_active(types: torch.Tensor) -> torch.Tensor:
    return (types == CellType.WATER) | (types == CellType.AIR)


def compute_extrapolated_velocities(old_types: torch.Tensor,
                                    vel: torch.Tensor) -> torch.Tensor:
    """Stage 04: per cell, the average velocity of its WATER neighbours
    under the old cell types; zero if none."""
    water = old_types == CellType.WATER
    vsum = torch.zeros_like(vel)
    count = torch.zeros(old_types.shape, dtype=vel.dtype, device=vel.device)
    for mv in MOVES:
        w = shifted(water, mv, fill=False)
        count = count + w
        vsum = vsum + shifted(vel, mv) * w
    return torch.where(count > 0, vsum / torch.clamp(count, min=1), 0.0)


def set_extrapolated_velocities(old_types: torch.Tensor,
                                new_types: torch.Tensor,
                                vel: torch.Tensor,
                                extrapolated: torch.Tensor) -> torch.Tensor:
    """Stage 05: a face is active iff either adjacent cell is WATER or AIR;
    was/is -> keep, reset to 0, or take the extrapolated value."""
    was_here = _is_active(old_types)
    is_here = _is_active(new_types)
    out = []
    for c in range(3):
        mv = tuple(-1 if k == c else 0 for k in range(3))
        was = was_here | shifted(was_here, mv, fill=False)
        is_ = is_here | shifted(is_here, mv, fill=False)
        comp = torch.where(was & ~is_, 0.0,
                           torch.where(~was & is_, extrapolated[c], vel[c]))
        out.append(comp)
    return torch.stack(out)


def advect_gather(types: torch.Tensor, vel: torch.Tensor,
                  cfg: FluidConfig) -> torch.Tensor:
    """Stage 07, reference-shaped path: per-point trilinear gathers
    (`07_advect/advect.comp:52-97`); exact for any CFL."""
    gx, gy, gz = types.shape
    dev = vel.device
    base = torch.stack(torch.meshgrid(
        torch.arange(gx, dtype=vel.dtype, device=dev),
        torch.arange(gy, dtype=vel.dtype, device=dev),
        torch.arange(gz, dtype=vel.dtype, device=dev), indexing="ij"),
        dim=-1)
    out = []
    for c in range(3):
        cond = advect_condition(types, c)
        # made on the device (a host tensor cannot be captured in a graph)
        fmove = torch.full((3,), 0.5, dtype=vel.dtype, device=dev)
        fmove[c].fill_(0.0)
        pos = base + fmove
        back = pos - velocity_at(vel, pos) * cfg.dt
        sampled = velocity_component_at(vel, back, c)
        out.append(torch.where(cond, sampled, vel[c]))
    return torch.stack(out)


def advect_shift(types: torch.Tensor, vel: torch.Tensor, cfg: FluidConfig,
                 x0: int = 0, gx_total: int | None = None) -> torch.Tensor:
    """Stage 07, gather-free shift-select path: the trilinear sample as a
    hat-weighted sum over all offsets |delta| <= R of edge-replicated
    shifts, displacements clamped to [-R, R).  It is the K1 kernel's plain
    version (`kernels/advect.advect_all_plain`).

    On a halo-extended x-slab (the multi-device step), `x0` is the global x
    of its row 0 and `gx_total` the domain's x extent: the coordinate clamp
    and the i_x != 0 test are global; the caller keeps the rows at least
    R + 1 from the slab's ends."""
    gx = types.shape[0] if gx_total is None else gx_total
    return advect_slab_plain(vel, advect_conditions(types, x0),
                             cfg.advect_max_displacement, cfg.dt, x0, gx)


def advect(types: torch.Tensor, vel: torch.Tensor,
           cfg: FluidConfig) -> torch.Tensor:
    """Stage 07 dispatcher: "auto" and "pallas" take the K1 route (the
    CUDA kernel where `kernel_choice` picks it, else its plain version),
    "shift" and "gather" pin those formulations."""
    method = cfg.advect_method
    if method == "gather":
        return advect_gather(types, vel, cfg)
    if method == "shift":
        return advect_shift(types, vel, cfg)
    if method not in ("auto", "pallas"):
        raise ValueError(f"unknown advect_method {method!r}")
    if kernel_choice(cfg, vel.device):
        # K1 builds the condition masks from the types itself
        return advect_all_cuda(vel, types, cfg.advect_max_displacement,
                               cfg.dt)
    return advect_shift(types, vel, cfg)


def apply_forces(types: torch.Tensor, vel: torch.Tensor, cfg: FluidConfig,
                 force_field: torch.Tensor | None = None) -> torch.Tensor:
    """Stage 08: gravity on wet y-faces plus the fountain impulse and the
    configured extra cell forces (`08_forces/forces.comp:33-55`), then a
    scene's (3, X, Y, Z) `force_field`, component c on every face c whose
    cell or lower-c neighbour is WATER.  +y is down in the reference
    scene."""
    water = types == CellType.WATER
    wet_face = water | shifted(water, (0, -1, 0), fill=False)
    ynz = axis_nonzero(types.shape, 1, types.device)
    force = torch.where(wet_face & ynz, cfg.gravity, 0.0).to(vel.dtype)
    fountain = torch.zeros(types.shape, dtype=torch.bool, device=vel.device)
    # fill_ on a view: an item assignment copies a host scalar, which a
    # CUDA graph cannot capture
    fountain[cfg.fountain].fill_(True)
    force = force + torch.where(fountain & wet_face, cfg.fountain_force,
                                0.0).to(vel.dtype)
    out = vel.clone()
    out[1] = vel[1] + cfg.dt * force
    for cell, fvec in cfg.extra_forces:
        at = torch.zeros(types.shape, dtype=torch.bool, device=vel.device)
        at[tuple(cell)].fill_(True)
        for c in range(3):
            if fvec[c] == 0.0:
                continue
            mv = tuple(-1 if k == c else 0 for k in range(3))
            wet_c = water | shifted(water, mv, fill=False)
            out[c] = out[c] + torch.where(at & wet_c, cfg.dt * fvec[c],
                                          0.0).to(vel.dtype)
    if force_field is not None:
        for c in range(3):
            mv = tuple(-1 if k == c else 0 for k in range(3))
            wet_c = water | shifted(water, mv, fill=False)
            out[c] = out[c] + torch.where(wet_c, cfg.dt * force_field[c],
                                          0.0).to(vel.dtype)
    return out


def diffuse(types: torch.Tensor, vel: torch.Tensor,
            cfg: FluidConfig) -> torch.Tensor:
    """Stage 09: v' = (1 - 6*k*dt) v + k*dt * sum of 6 neighbours on WATER
    cells.  The reference shader assigns the result to a shadowed local,
    so `cfg.reference_diffuse_noop` (default) keeps the stage a copy."""
    if cfg.reference_diffuse_noop:
        return vel
    k = cfg.diffusion_coefficient * cfg.dt
    nsum = torch.zeros_like(vel)
    for mv in MOVES:
        nsum = nsum + shifted(vel, mv)
    diffused = (1.0 - 6.0 * k) * vel + k * nsum
    water = types == CellType.WATER
    return torch.where(water[None], diffused, vel)


def apply_solids(types: torch.Tensor, vel: torch.Tensor,
                 cfg: FluidConfig) -> torch.Tensor:
    """Stage 10: SOLID cells push every component out at least `repel`;
    a face whose lower neighbour in dim c is SOLID gets at least +repel."""
    # a Python number: compared and selected in f32 as a tensor would be,
    # and nothing copied from the host inside the step
    r = cfg.solid_repel_velocity
    solid = types == CellType.SOLID
    out = []
    for c in range(3):
        v = vel[c]
        v = torch.where(solid & (v > -r), -r, v)
        mv = tuple(-1 if k == c else 0 for k in range(3))
        lower_solid = shifted(solid, mv, fill=False)
        v = torch.where(lower_solid & (v < r), r, v)
        out.append(v)
    return torch.stack(out)
