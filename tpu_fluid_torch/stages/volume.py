"""Volume-conservation drift (`tpu_fluid.stages.volume`), a beyond-reference
option: `FluidConfig.volume_correction = k` (0 = off, the reference's
behaviour, whose fluid volume slowly expands, its `README.md:147-149`).

Per corrected step, with per-cell particle counts d and target density d0:

    err  = (d - d0) / d0                    on WATER cells
    lap(phi) = err,  phi = 0 off water      (`pressure.poisson_solve`,
                                             boundary 0: K2f and K2 on
                                             the card)
    drift_c(i) = clamp(k * (phi(i) - phi(i - e_c)), -m, m)
                                            on the faces stage 13 projects

Stage 14 moves the particles through vel + drift; the state keeps `vel`.
With `mesh` (the x-slab step) the counts and types are this shard's slabs:
the solve runs sharded and the drift stencil reads one halo plane.
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.ops.scatter import particle_cell_histogram
from tpu_fluid_torch.ops.stencil import axis_nonzero, div_const, shifted
from tpu_fluid_torch.stages import pressure


def volume_due(cfg: FluidConfig, step: int) -> bool:
    """Whether the step numbered `step` moves the particles through the
    drift: volume correction on, and `step % volume_correction_every == 0`
    (JAX's `lax.cond`, `tpu_fluid/solver/step.py:93-109`)."""
    every = max(1, cfg.volume_correction_every)
    return cfg.volume_correction > 0.0 and step % every == 0


def density_error(counts: torch.Tensor, types: torch.Tensor,
                  cfg: FluidConfig) -> torch.Tensor:
    """(counts - d0) / d0 on WATER cells, 0 elsewhere: the right-hand side
    of the volume solve."""
    d0 = cfg.volume_target_density_value
    return torch.where(types == CellType.WATER,
                       div_const(counts.to(torch.float32) - d0, d0), 0.0)


def volume_potential(counts: torch.Tensor, types: torch.Tensor,
                     cfg: FluidConfig, mesh=None) -> torch.Tensor:
    """phi with lap(phi) = (counts - d0) / d0 on WATER cells and phi = 0
    elsewhere, `cfg.volume_jacobi_iters` sweeps of the pressure solver."""
    err = density_error(counts, types, cfg)
    return pressure.poisson_solve(types, err, cfg,
                                  iters=cfg.volume_jacobi_iters,
                                  boundary_value=0.0, mesh=mesh)


def density_drift(counts: torch.Tensor, types: torch.Tensor,
                  cfg: FluidConfig, mesh=None, x0: int = 0) -> torch.Tensor:
    """(X, Y, Z) counts and types -> (3, X, Y, Z) staggered drift
    velocities.  Component c of cell i is clamp(k * (phi(i) - phi(i -
    e_c)), -m, m) iff i_c != 0, one of the two cells is WATER and neither
    is SOLID (stage 13's face rule), else 0.  With `mesh`, the slabs of
    shard `mesh.rank` whose row 0 is the global x `x0`."""
    k = cfg.volume_correction
    m = cfg.volume_drift_max
    phi = volume_potential(counts, types, cfg, mesh)
    water = types == CellType.WATER
    solid = types == CellType.SOLID
    if mesh is not None:
        from tpu_fluid_torch.parallel.halo import halo_extend, halo_inner
        types_e = halo_extend(types, 1, mesh)
        phi_e = halo_extend(phi, 1, mesh)
    out = []
    for c in range(3):
        mv = tuple(-1 if j == c else 0 for j in range(3))
        if mesh is not None and c == 0:
            # the -x neighbour shard's boundary plane; zeros past x = 0
            lo_w = halo_inner(shifted(types_e == CellType.WATER, mv,
                                      fill=False))
            lo_s = halo_inner(shifted(types_e == CellType.SOLID, mv,
                                      fill=False))
            grad = phi - halo_inner(shifted(phi_e, mv))
            nonzero = (torch.arange(x0, x0 + types.shape[0],
                                    device=types.device) != 0
                       ).reshape(-1, 1, 1)
        else:
            lo_w = shifted(water, mv, fill=False)
            lo_s = shifted(solid, mv, fill=False)
            grad = phi - shifted(phi, mv)
            nonzero = axis_nonzero(types.shape, c, types.device)
        ok = nonzero & (water | lo_w) & ~solid & ~lo_s
        drift = torch.clamp(k * grad, -m, m)
        out.append(torch.where(ok, drift, 0.0))
    return torch.stack(out)


def corrected_move_velocity(vel: torch.Tensor, positions: torch.Tensor,
                            active: torch.Tensor, types: torch.Tensor,
                            cfg: FluidConfig) -> torch.Tensor:
    """The field stage 14 samples on a corrected step: vel plus the
    drift of the sim-grid particle counts."""
    counts = particle_cell_histogram(positions, active, cfg.grid_size)
    return vel + density_drift(counts, types, cfg)
