"""Per-stage timing (`tpu_fluid.utils.profiling`): the steps/s measurement
and a per-stage-group breakdown.

Every timer chains its iterations, x_{k+1} = f(x_k).  On the card the n
iterations are captured into one CUDA graph, the counterpart of JAX's
`lax.fori_loop` inside one program, and a replay is timed by CUDA events
after one untimed replay: the host's dispatch of each op does not show.
On the CPU the host clock times n eager calls after one untimed call.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.state import FluidState, initial_state
from tpu_fluid_torch.kernels import fuse_grid_choice, kernel_choice
from tpu_fluid_torch.solver.step import simulation_step, step

TOTAL = "TOTAL full step"


@torch.no_grad()
def time_chained(f: Callable, x0, n: int = 10) -> float:
    """Milliseconds per call of the self-map f over n chained calls
    (x_{k+1} = f(x_k)); x0 is a tensor or a tuple of tensors, which f does
    not modify in place."""
    device = (x0 if isinstance(x0, torch.Tensor) else x0[0]).device
    if device.type != "cuda":
        f(x0)
        t0 = time.perf_counter()
        x = x0
        for _ in range(n):
            x = f(x)
        return (time.perf_counter() - t0) / n * 1000.0
    with torch.cuda.device(device):
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            f(x0)                       # fills the host-side caches
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            x = x0
            for _ in range(n):
                x = f(x)
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / n


def time_step(cfg: FluidConfig, n: int = 20,
              state: FluidState | None = None) -> float:
    """ms per full simulation step (from `initial_state(cfg)`, on the card,
    unless a state is given)."""
    if state is None:
        state = initial_state(cfg)
    return time_chained(lambda s: simulation_step(s, cfg), state, n=n)


def stage_breakdown(cfg: FluidConfig, n: int = 10, warm_steps: int = 3,
                    device="cuda") -> Dict[str, float]:
    """ms per stage group, each timed as a chained self-map on the state
    after `warm_steps` steps, in the groups the port's step runs.  JAX's
    keys map onto them so:

      JAX                              the port, unfused path
      01+15 occupancy scatter    ->    15 in "14+15 move and scatter" (the
                                       scatter is in K3+K4), 01's max-pool
                                       in "01-03 pool and cell typing"
      02+03 cell typing          ->    "01-03 pool and cell typing"
      04+05 extrapolate          ->    "04+05 extrapolate"
      07 advect                  ->    "07 advect" (K1)
      08-10 forces/solids        ->    "08-10 forces/solids"
      11 divergence              ->    "11 divergence"
      12 jacobi xN               ->    "12 jacobi xN" (the fold and K2)
      13 project                 ->    "13 project"
      14 move particles          ->    "14+15 move and scatter" (K3+K4)
      16-18 surface fields       ->    "16-18 surface fields" (K5 and its
                                       skip mask)
      TOTAL full step            ->    "TOTAL full step"

    Where `fuse_grid_choice` holds (256^3), the K6 groups replace five of
    them: "01-06 classify and extrapolate (K6a)" takes 01-05,
    "08-11 forces, solids, divergence (K6b)" takes 08-10 and 11, and
    "13 project (K6c)" takes 13.  The port has no compiler that could drop
    or reuse a call, so a group whose result is not its input's kind (the
    cell typing from the occupancy) runs on the state's fields and
    returns its input's kind unchanged."""
    from tpu_fluid_torch.kernels import grid_fused
    from tpu_fluid_torch.stages import (celltypes, particles, pressure,
                                        surface_fields)
    from tpu_fluid_torch.stages import velocity as vstages

    state = initial_state(cfg, device)
    for _ in range(warm_steps):
        state = step(state, cfg)
    types, vel = state.cell_types, state.velocity
    pos, act, occ = state.positions, state.active, state.detailed_occ
    div = pressure.compute_divergence(vel)
    p = pressure.jacobi_solve(types, div, cfg)
    fused = fuse_grid_choice(cfg, vel.device)
    kernels = fused and kernel_choice(cfg, vel.device)
    pool = cfg.surface_render_resolution

    out = {}
    if fused:
        classify = (grid_fused.classify_extrap_cuda if kernels
                    else grid_fused.classify_extrap_plain)
        forces = (grid_fused.forces_solids_div_cuda if kernels
                  else grid_fused.forces_solids_div_plain)
        project = grid_fused.project_cuda if kernels else \
            grid_fused.project_plain
        out["01-06 classify and extrapolate (K6a)"] = time_chained(
            lambda v: classify(occ, types, v, cfg, pool=pool)[1], vel, n=n)
    else:
        def cell_typing(t):
            sim = particles.occupancy_to_sim_grid(occ, cfg)
            celltypes.update_air(celltypes.update_water(sim), cfg)
            return t

        out["01-03 pool and cell typing"] = time_chained(cell_typing, types,
                                                         n=n)
        out["04+05 extrapolate"] = time_chained(
            lambda v: vstages.set_extrapolated_velocities(
                types, types, v, vstages.compute_extrapolated_velocities(
                    types, v)), vel, n=n)
    out["07 advect"] = time_chained(
        lambda v: vstages.advect(types, v, cfg), vel, n=n)
    if fused:
        out["08-11 forces, solids, divergence (K6b)"] = time_chained(
            lambda v: forces(types, v, cfg)[0], vel, n=n)
    else:
        out["08-10 forces/solids"] = time_chained(
            lambda v: vstages.apply_solids(
                types, vstages.diffuse(types, vstages.apply_forces(
                    types, v, cfg), cfg), cfg), vel, n=n)

        def divergence(v):
            pressure.compute_divergence(v)
            return v

        out["11 divergence"] = time_chained(divergence, vel, n=n)
    out[f"12 jacobi x{cfg.jacobi_iters}"] = time_chained(
        lambda d: pressure.jacobi_solve(types, d, cfg), div, n=max(2, n // 2))
    if fused:
        out["13 project (K6c)"] = time_chained(
            lambda v: project(types, p, v, cfg), vel, n=n)
    else:
        out["13 project"] = time_chained(
            lambda v: pressure.pressure_project(types, p, v, cfg), vel, n=n)
    out["14+15 move and scatter"] = time_chained(
        lambda q: particles.move_and_scatter(vel, q, act, cfg)[0], pos, n=n)
    out["16-18 surface fields"] = time_chained(
        lambda f2: surface_fields.update_surface_fields(
            types, occ, state.inertia, f2, cfg)[2], state.float_dens_2, n=n)
    out[TOTAL] = time_step(cfg, n=n, state=state)
    return out


def print_breakdown(cfg: FluidConfig, n: int = 10, device="cuda") -> None:
    bd = stage_breakdown(cfg, n=n, device=device)
    total = bd.get(TOTAL, 0.0)
    print(f"grid={cfg.grid_size} particles={cfg.particle_count} "
          f"jacobi={cfg.jacobi_iters} detailed={cfg.detailed_size}")
    for k, v in bd.items():
        frac = f" ({100 * v / total:4.0f}%)" if total and k != TOTAL else ""
        print(f"  {k:40s} {v:8.3f} ms{frac}")
