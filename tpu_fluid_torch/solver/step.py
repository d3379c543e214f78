"""Full simulation step (`tpu_fluid.solver.step`): the reference's 19-stage
per-frame compute graph (`fluid_flow_sections.h:159-391`) as one function
over the state, run eagerly.  The kernel-bearing stages (07, 12, 14-15,
16-18) pick their CUDA kernel or its plain version through
`kernel_choice`; where `fuse_grid_choice` holds, stages 01-06, 08-11 and 13
run as the three K6 groups, again as kernels or plain versions by
`kernel_choice`."""

from __future__ import annotations

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.state import NOWHERE, FluidState
from tpu_fluid_torch.kernels import fuse_grid_choice, kernel_choice
from tpu_fluid_torch.kernels import grid_fused
from tpu_fluid_torch.stages import celltypes, particles, pressure
from tpu_fluid_torch.stages import surface_fields
from tpu_fluid_torch.stages.volume import (corrected_move_velocity,
                                           volume_due)
from tpu_fluid_torch.stages import velocity as vstages
from tpu_fluid_torch.utils import profiling


def simulation_step(state: FluidState, cfg: FluidConfig, scene=None,
                    volume_step: int | None = None,
                    into: FluidState | None = None) -> FluidState:
    """One frame, stage order exactly as the reference's step section list:

      01 histogram -> 02 water -> 03 air/solid -> 04/05 extrapolate ->
      06 commit types -> 07 advect -> 08 forces -> 09 diffuse -> 10 solids ->
      11 divergence -> 12 Jacobi xN -> 13 project -> 14 move particles ->
      15 detail histogram -> 16 inertia -> 17 signed field -> 18 blur xM

    `scene` is an optional `core/scene_fields.SceneFields`.  With volume
    correction every K > 1 steps, the step runs the correction or not as
    JAX's `lax.cond` does, one branch: `volume_step` is the caller's
    value of `state.step` (the CUDA graphs pass it), else the step reads
    it from the state.

    `into` (the CUDA graphs pass it) holds tensors that the new state's
    fields are written into, each by the field's last writer (a None
    field is allocated, as every field is without `into`).  The step
    never reads them, and they must share no memory with `state`.

    With tracing on (`utils/profiling`), the stage groups that
    `profiling.stage_breakdown` names tile the step, each a span.
    """
    put = into if into is not None else NOWHERE
    device = state.velocity.device
    fuse_grid = fuse_grid_choice(cfg, device, scene)
    scene_solid = scene.solid if scene is not None else None
    scene_force = scene.force if scene is not None else None
    if fuse_grid and kernel_choice(cfg, device):
        classify_extrap = grid_fused.classify_extrap_cuda
        forces_solids_div = grid_fused.forces_solids_div_cuda
        project = grid_fused.project_cuda
    else:
        classify_extrap = grid_fused.classify_extrap_plain
        forces_solids_div = grid_fused.forces_solids_div_plain
        project = grid_fused.project_plain

    old_types = state.cell_types
    vel = state.velocity
    stage = profiling.stages()

    if fuse_grid:
        stage("01-06 classify and extrapolate (K6a)")
        # 01-06 in one pass (K6a), from the detailed occupancy of the
        # current positions, scattered at the end of the previous step
        types, vel = classify_extrap(state.detailed_occ, old_types, vel, cfg,
                                     pool=cfg.surface_render_resolution,
                                     out=(put.cell_types, None))
    else:
        stage("01-03 pool and cell typing")
        # 01: sim-grid occupancy of the current positions
        occ_sim = particles.occupancy_to_sim_grid(state.detailed_occ, cfg)
        # 02-03: classify cells
        new_types = celltypes.update_water(occ_sim)
        new_types = celltypes.update_air(new_types, cfg,
                                         extra_solid=scene_solid,
                                         out=put.cell_types)
        stage("04+05 extrapolate")
        # 04-05: velocity extrapolation into newly active faces
        extrapolated = vstages.compute_extrapolated_velocities(old_types,
                                                               vel)
        vel = vstages.set_extrapolated_velocities(old_types, new_types, vel,
                                                  extrapolated)
        # 06: the new classification becomes current
        types = celltypes.commit_cell_types(new_types)

    stage("07 advect")
    vel = vstages.advect(types, vel, cfg)

    if fuse_grid:
        stage("08-11 forces, solids, divergence (K6b)")
        # 08-11 in one pass (K6b; 09 is the reference's no-op)
        vel, div = forces_solids_div(types, vel, cfg)
    else:
        stage("08-10 forces/solids")
        # 08-10: force, diffuse, solid clamp
        vel = vstages.apply_forces(types, vel, cfg,
                                   force_field=scene_force)
        vel = vstages.diffuse(types, vel, cfg)
        vel = vstages.apply_solids(types, vel, cfg)
        stage("11 divergence")
        div = pressure.compute_divergence(vel)

    stage(f"12 jacobi x{cfg.jacobi_iters}")
    p = pressure.jacobi_solve(types, div, cfg)
    if fuse_grid:
        stage("13 project (K6c)")
        vel = project(types, p, vel, cfg, out=put.velocity)
    else:
        stage("13 project")
        vel = pressure.pressure_project(types, p, vel, cfg,
                                        out=put.velocity)

    # 14-15: move particles through the projected field, plus the volume
    # drift on a corrected step, and scatter their occupancy (also the
    # next frame's stage 01), one K3+K4 launch on the card
    stage("14+15 move and scatter")
    move_vel = vel
    if cfg.volume_correction > 0.0:
        if volume_step is None and cfg.volume_correction_every > 1:
            volume_step = int(state.step)
        if volume_due(cfg, volume_step or 0):
            move_vel = corrected_move_velocity(vel, state.positions,
                                               state.active, types, cfg)
    pos, occ = particles.move_and_scatter(
        move_vel, state.positions, state.active, cfg,
        out=(put.positions, put.detailed_occ))

    stage("16-18 surface fields")
    if cfg.surface_enabled:
        inertia, f1, f2 = surface_fields.update_surface_fields(
            types, occ, state.inertia, state.float_dens_2, cfg,
            out=(put.inertia, put.float_dens_1, put.float_dens_2))
    else:
        inertia, f1, f2 = (state.inertia, state.float_dens_1,
                           state.float_dens_2)
    counter = torch.add(state.step, 1, out=put.step)
    stage()

    return FluidState(
        velocity=vel,
        cell_types=types,
        inertia=inertia,
        float_dens_1=f1,
        float_dens_2=f2,
        positions=pos,
        active=state.active,
        detailed_occ=occ,
        step=counter,
        dropped=state.dropped,
    )


@torch.no_grad()
def step(state: FluidState, cfg: FluidConfig, scene=None) -> FluidState:
    """One eager step with autograd off.  `solver/graph.jit_step` replays
    it as a CUDA graph, the counterpart of the JAX package's `jit_step`.
    With volume correction every K > 1 steps it reads `state.step` on the
    host, once a step."""
    if scene is not None:
        scene.validate(cfg)
    return simulation_step(state, cfg, scene)
