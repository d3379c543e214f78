"""Particle stages: occupancy (01, 15) and particle advection (14)
(`tpu_fluid.stages.particles`)."""

from __future__ import annotations

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.kernels import kernel_choice
from tpu_fluid_torch.kernels.particle_move import (particle_move_cuda,
                                                   particle_move_plain)
from tpu_fluid_torch.ops.sampling import velocity_at


def detailed_occupancy(positions: torch.Tensor, active: torch.Tensor,
                       cfg: FluidConfig) -> torch.Tensor:
    """Occupancy (0/1 uint8) of the detailed grid.  The pipeline only ever
    consumes density > 0 (stage 02's water test, stage 16's filled and
    neighbour tests), so one scatter of the constant 1 serves both of the
    reference's histograms.  Indices truncate toward zero; inactive and
    out-of-grid particles are routed to a dropped slot (never clamped), and
    duplicates all write 1, so the scatter is deterministic."""
    dx, dy, dz = cfg.detailed_size
    idx = torch.trunc(positions * float(cfg.surface_render_resolution)
                      ).to(torch.int64)
    x, y, z = idx[:, 0], idx[:, 1], idx[:, 2]
    inb = ((x >= 0) & (x < dx) & (y >= 0) & (y < dy) & (z >= 0) & (z < dz)
           & active)
    n = dx * dy * dz
    flat = torch.where(inb, x * (dy * dz) + y * dz + z, n)
    occ = torch.zeros(n + 1, dtype=torch.uint8, device=positions.device)
    occ[flat] = 1
    return occ[:n].reshape(dx, dy, dz)


def occupancy_to_sim_grid(occ: torch.Tensor,
                          cfg: FluidConfig) -> torch.Tensor:
    """Sim-grid occupancy: the max over each res^3 block of the detailed
    occupancy (a u8 max-pool), of the whole grid or of an x-slab.  The
    fused grid path (K6a) pools inside its kernel instead."""
    return pool_occupancy(occ, cfg.surface_render_resolution)


def pool_occupancy(occ: torch.Tensor, r: int) -> torch.Tensor:
    """The max over each r^3 block of `occ`."""
    dx, dy, dz = occ.shape
    return occ.reshape(dx // r, r, dy // r, r, dz // r, r).amax(dim=(1, 3, 5))


def move_particles(vel: torch.Tensor, positions: torch.Tensor,
                   active: torch.Tensor, cfg: FluidConfig) -> torch.Tensor:
    """Stage 14: forward-Euler particle advection with staggered trilinear
    velocity sampling (`particles.comp:27-52`), no position clamping.  The
    "packed" sampler takes the K3+K4 route (the CUDA kernel where
    `kernel_choice` picks it, else its plain version); "gather" samples with
    per-point gathers."""
    if cfg.particle_sampler == "packed":
        if kernel_choice(cfg, vel.device):
            return particle_move_cuda(vel, positions, active, cfg.dt)
        return particle_move_plain(vel, positions, active, cfg.dt)
    if cfg.particle_sampler != "gather":
        raise ValueError(f"unknown particle_sampler {cfg.particle_sampler!r}")
    v = velocity_at(vel, positions)
    return torch.where(active[:, None], positions + v * cfg.dt, positions)
