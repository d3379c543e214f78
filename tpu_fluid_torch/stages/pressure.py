"""Pressure stages: divergence (11), Jacobi iteration (12), projection (13)
(`tpu_fluid.stages.pressure`).

The Jacobi solve always takes the JAX package's kernel formulation: the
per-cell constants fold into (q0, rd code, c2e), in one K2f launch on a
single device, and the sweeps run in the K2 kernel; both run their plain
versions where `kernel_choice` does not pick the kernels.  The red-black
Gauss-Seidel solve (`pressure_solver="redblack"`) runs only as XLA in the
JAX package, so here it is plain torch in JAX's unfolded form, added in
the same order.

With `mesh` (the x-slab multi-device step; JAX passes `axis_name`) the
inputs and the result are this shard's slabs: the same fold runs on the
slab extended by one halo plane of the types (`fold_slab`), and the sweeps
exchange planes with the neighbours
(`kernels/jacobi.jacobi_sweeps_sharded_cuda`, or its plain version, which
adds in the kernel's order too; JAX's XLA route adds in `MOVES` order).
Every result equals the single-device one bitwise.
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.kernels import kernel_choice
from tpu_fluid_torch.kernels.jacobi import (jacobi_fold_cuda,
                                            jacobi_fold_plain,
                                            jacobi_sweeps_cuda,
                                            jacobi_sweeps_plain,
                                            jacobi_sweeps_sharded_cuda,
                                            jacobi_sweeps_sharded_plain)
from tpu_fluid_torch.ops.stencil import MOVES, axis_nonzero, shifted
from tpu_fluid_torch.utils import profiling


def compute_divergence(vel: torch.Tensor) -> torch.Tensor:
    """Stage 11: div(i) = sum_c v_c(i + e_c) - v_c(i), zero outside."""
    div = torch.zeros(vel.shape[1:], dtype=vel.dtype, device=vel.device)
    for c in range(3):
        up = tuple(1 if k == c else 0 for k in range(3))
        div = div + shifted(vel[c], up) - vel[c]
    return div


def jacobi_stats(types: torch.Tensor, cfg: FluidConfig):
    """Per-frame constants of the sweep: water mask, the diagonal count aii
    (non-solid neighbours) and the number of non-solid, non-water
    neighbours, each contributing the constant air pressure."""
    water = types == CellType.WATER
    solid = types == CellType.SOLID
    aii = torch.zeros(types.shape, dtype=torch.float32, device=types.device)
    n_air = torch.zeros_like(aii)
    for mv in MOVES:
        nb_solid = shifted(solid, mv, fill=False)
        nb_water = shifted(water, mv, fill=False)
        aii = aii + (~nb_solid)
        n_air = n_air + (~nb_solid & ~nb_water)
    return water, aii, n_air


def jacobi_solve(types: torch.Tensor, div: torch.Tensor,
                 cfg: FluidConfig, mesh=None) -> torch.Tensor:
    """Stage 12: Jacobi pressure iteration on WATER cells with
    b = div * rho * dx / dt.  With `cfg.reference_pressure_parity` it runs
    jacobi_iters - 1 sweeps: the reference's projection reads the 199th of
    its 200 alternating iterates."""
    iters = cfg.jacobi_iters - (1 if cfg.reference_pressure_parity else 0)
    return poisson_solve(types, div.to(torch.float32), cfg, iters=iters,
                         boundary_value=cfg.air_pressure,
                         scale=cfg.fluid_density * cfg.cell_width / cfg.dt,
                         mesh=mesh)


def fold_slab(fold, types: torch.Tensor, div: torch.Tensor, scale: float,
              boundary_value: float, mesh) -> tuple:
    """(q0, code, c2e) of this shard's x-slab by `fold` (K2f or
    `jacobi_fold_plain`): the fold of the slab extended by one plane of
    the neighbour shards' types, with those planes stripped again.  Past
    the domain ends the plane is zeros, INACTIVE, as the fold's own pad,
    so the result is the single-device fold's rows bitwise.  The exchange
    is an `exchange.solve` span under tracing."""
    from tpu_fluid_torch.parallel.halo import halo_extend, halo_inner
    div = torch.nn.functional.pad(div, (0, 0, 0, 0, 1, 1))
    with profiling.span("exchange.solve"):
        types_e = halo_extend(types, 1, mesh)
    return tuple(halo_inner(a) for a in fold(
        types_e, div, scale, boundary_value))


def poisson_solve(types: torch.Tensor, div: torch.Tensor, cfg: FluidConfig,
                  iters: int, boundary_value: float, scale: float = 1.0,
                  mesh=None) -> torch.Tensor:
    """On WATER cells with aii > 0, iterate
        p = (sum_{water nbrs} p + n_air * boundary_value - rhs) / aii
    `iters` times from p0 = boundary_value, with rhs = div * scale (a
    scale of 1.0 is exact), in the folded form
        q' = rd * sum_6(q) + c2e,  q = where(water, p, 0)
    with rd shipped as the u8 aii code; non-water cells read back as
    boundary_value."""
    if cfg.pressure_solver not in ("jacobi", "redblack"):
        raise ValueError(f"unknown pressure_solver {cfg.pressure_solver!r}")
    if cfg.pressure_solver == "redblack":
        return redblack_solve(types, div * scale, cfg, iters, boundary_value,
                              mesh)
    kernel = kernel_choice(cfg, types.device)
    fold = jacobi_fold_cuda if kernel else jacobi_fold_plain
    if mesh is None:
        q0, code, c2e = fold(types, div, scale, boundary_value)
        sweeps = jacobi_sweeps_cuda if kernel else jacobi_sweeps_plain
        q = sweeps(q0, code, c2e, iters)
    else:
        q0, code, c2e = fold_slab(fold, types, div, scale, boundary_value,
                                  mesh)
        sweeps = (jacobi_sweeps_sharded_cuda if kernel
                  else jacobi_sweeps_sharded_plain)
        q = sweeps(q0, code, c2e, iters, mesh)
    return torch.where(types == CellType.WATER, q, boundary_value)


def redblack_solve(types: torch.Tensor, rhs: torch.Tensor, cfg: FluidConfig,
                   iters: int, boundary_value: float,
                   mesh=None) -> torch.Tensor:
    """`poisson_solve` by red-black Gauss-Seidel: each of the `iters`
    sweeps updates the cells with (x + y + z) even, then the odd ones from
    the fresh even half, each by
        p = (sum of the six pw neighbours + const) / max(aii, 1)
    with pw = where(water, p, 0), the neighbours added to zeros in MOVES
    order, and const = n_air * boundary_value - rhs, as JAX's XLA sweep
    (`tpu_fluid/stages/pressure.py:188-211`).  With `mesh` the parity takes
    the global x and the x neighbours come from the neighbour shards'
    planes, one exchange a half-sweep (`:157-172`)."""
    if mesh is not None:
        from tpu_fluid_torch.parallel.halo import (halo_extend, halo_inner,
                                                   halo_planes)
        water, aii, n_air = (halo_inner(a) for a in jacobi_stats(
            halo_extend(types, 1, mesh), cfg))
        x0 = mesh.rank * types.shape[0]
    else:
        water, aii, n_air = jacobi_stats(types, cfg)
        x0 = 0
    dev = types.device
    const = n_air * boundary_value - rhs.to(torch.float32)
    denom = torch.clamp(aii, min=1.0)
    update = water & (aii > 0)
    lx, gy, gz = types.shape
    even = ((torch.arange(x0, x0 + lx, device=dev)[:, None, None]
             + torch.arange(gy, device=dev)[None, :, None]
             + torch.arange(gz, device=dev)[None, None, :]) % 2) == 0
    halves = (update & even, update & ~even)
    dry = ~water
    # pw with a ring of zeros: each shifted neighbour is a view of it
    pad = torch.zeros((lx + 2, gy + 2, gz + 2), dtype=torch.float32,
                      device=dev)
    inner = pad[1:-1, 1:-1, 1:-1]
    views = {mv: pad[1 + mv[0]:1 + mv[0] + lx, 1 + mv[1]:1 + mv[1] + gy,
                     1 + mv[2]:1 + mv[2] + gz] for mv in MOVES}
    p = torch.full(types.shape, boundary_value, dtype=torch.float32,
                   device=dev)
    for _ in range(iters):
        for mask in halves:
            inner.copy_(p)
            inner.masked_fill_(dry, 0.0)
            if mesh is not None:
                left, right = halo_planes(inner, 1, mesh)
                pad[:1, 1:-1, 1:-1].copy_(left)
                pad[-1:, 1:-1, 1:-1].copy_(right)
            neigh = torch.zeros_like(p)
            for mv in MOVES:
                neigh.add_(views[mv])
            p = torch.where(mask, (neigh + const) / denom, p)
    return p


def pressure_project(types: torch.Tensor, pressure: torch.Tensor,
                     vel: torch.Tensor, cfg: FluidConfig,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Stage 13: component c of cell i changes by -dt/(rho*dx) *
    (p(i) - p(i - e_c)) iff i_c != 0, one of the two cells is WATER and
    neither is SOLID.  The result is written into `out` where given."""
    return torch.stack(project_components(types, pressure, vel, cfg),
                       out=out)


def project_components(types: torch.Tensor, pressure: torch.Tensor,
                       vel: torch.Tensor, cfg: FluidConfig) -> list:
    """`pressure_project`'s three components, before they are stacked
    (the sharded step stacks their interior rows)."""
    water = types == CellType.WATER
    solid = types == CellType.SOLID
    scale = cfg.dt / (cfg.fluid_density * cfg.cell_width)
    out = []
    for c in range(3):
        mv = tuple(-1 if k == c else 0 for k in range(3))
        lo_water = shifted(water, mv, fill=False)
        lo_solid = shifted(solid, mv, fill=False)
        cond = (axis_nonzero(types.shape, c, types.device)
                & (water | lo_water) & ~solid & ~lo_solid)
        grad = pressure - shifted(pressure, mv)
        dv = torch.where(cond, grad, 0.0).to(vel.dtype)
        out.append(vel[c] - scale * dv)
    return out
