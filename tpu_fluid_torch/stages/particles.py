"""Particle stages: histograms and occupancy (01, 15) and particle
advection (14) (`tpu_fluid.stages.particles`)."""

from __future__ import annotations

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.kernels import kernel_choice, store
from tpu_fluid_torch.kernels.particle_move import (particle_move_cuda,
                                                   particle_move_plain,
                                                   scatter_occupancy)
from tpu_fluid_torch.ops.sampling import velocity_at
from tpu_fluid_torch.ops.scatter import particle_cell_histogram


def particle_densities(positions: torch.Tensor, active: torch.Tensor,
                       cfg: FluidConfig) -> torch.Tensor:
    """Stage 01 as the reference computes it: the particles-per-cell
    histogram of the sim grid (`update_densities.comp:29-36`).  The step
    needs only the occupancy; the volume correction counts with it."""
    return particle_cell_histogram(positions, active, cfg.grid_size)


def detailed_densities(positions: torch.Tensor, active: torch.Tensor,
                       cfg: FluidConfig) -> torch.Tensor:
    """Stage 15 as the reference computes it: the particles-per-cell
    histogram of the detailed grid, indexed by pos * resolution
    (`update_detailed_densities.comp:24-32`)."""
    return particle_cell_histogram(
        positions, active, cfg.detailed_size,
        scale=float(cfg.surface_render_resolution))


def detailed_occupancy(positions: torch.Tensor, active: torch.Tensor,
                       cfg: FluidConfig) -> torch.Tensor:
    """Stage 15: the 0/1 u8 occupancy of the detailed grid
    (`kernels/particle_move.scatter_occupancy`): truncated indices, the
    inactive and out-of-grid particles dropped, never clamped."""
    return scatter_occupancy(positions, active, cfg.surface_render_resolution,
                             cfg.detailed_size)


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
    "packed" sampler is K3+K4's plain version, "gather" samples with
    per-point gathers.  The step runs it through `move_and_scatter`, which
    takes K3+K4 on the card."""
    if cfg.particle_sampler == "packed":
        return particle_move_plain(vel, positions, active, cfg.dt)
    if cfg.particle_sampler != "gather":
        raise ValueError(f"unknown particle_sampler {cfg.particle_sampler!r}")
    v = velocity_at(vel, positions)
    return torch.where(active[:, None], positions + v * cfg.dt, positions)


def move_and_scatter(vel: torch.Tensor, positions: torch.Tensor,
                     active: torch.Tensor, cfg: FluidConfig,
                     out=None) -> tuple:
    """Stages 14 and 15: (the moved positions, the detailed occupancy of
    the moved active ones), written into `out`'s two tensors where given.
    With the "packed" sampler, where `kernel_choice` picks the kernels,
    one K3+K4 launch does both; otherwise `move_particles`, then
    `detailed_occupancy`."""
    if cfg.particle_sampler == "packed" and kernel_choice(cfg, vel.device):
        return particle_move_cuda(vel, positions, active, cfg.dt,
                                  cfg.surface_render_resolution, out=out)
    pos = move_particles(vel, positions, active, cfg)
    return store((pos, detailed_occupancy(pos, active, cfg)), out)
