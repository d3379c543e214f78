"""The x-slab multi-device step (`tpu_fluid.parallel.spmd_step`): the
19-stage step on this shard's local slabs, with explicit halo exchange
between neighbouring shards, one process per shard on `torch.distributed`.

Each stage runs on the local slabs with the halo planes it reads, and uses
global coordinates wherever the single-device step uses positions (the
border and box SOLID rule, the fountain and force cells, the advection
clamps, the i_x != 0 tests).  Where `kernel_choice` picks the kernels, the
kernel stages run their halo forms: K1 (advection), K2's sharded passes
(Jacobi), K6a-c (the fused grid groups, where `fuse_grid_choice` holds and
the slab has 2 rows or more) and K5 (the surface fields, where the
detailed slab is at least steps + 1 rows wide).

Particles (stages 14-15) follow `cfg.particle_sharding`:
  - "index" (the default): `mesh.shard_state` splits them by index; each
    shard gathers the whole velocity field, moves its particles and
    scatters their occupancy over the whole detailed grid in one K3+K4
    launch, and the shards' occupancies are summed with a psum_scatter
    onto the x-slabs.
  - "domain": `particles_domain.domain_shard_state` puts each particle on
    the shard that owns its x-slab; each shard moves its particles through
    K3+K4's local-slab form on its edge-replicated slab, `migrate` hands
    the border crossers to the neighbours, and the occupancy is scattered
    onto the local detailed slab.  No all_gather and no psum_scatter run.

The options beyond the reference run as in JAX's step: a scene's slabs
(`mesh.shard_scene`) in stages 03 and 08; the volume drift from the
slab's particle counts (index sharding: the whole grid's counts of each
shard's particles, psum_scatter onto the slabs; domain sharding: the
slab's own), by the sharded solve, added to the slab before any gather;
the level set on a block with a halo of its band; the red-black solver
with one plane exchanged a half-sweep.

Every stage adds in the single-device order, so the gathered grid fields
equal the single-device step's bitwise, and so do the particles: in slot
order under index sharding, as a set under domain sharding
(tests/test_torch_spmd.py, tests/test_torch_particles_domain.py).

Entry points: `spmd_step` and `spmd_multi_step` step eagerly, reading
`state.step` on the host for the volume cadence; `jit_spmd_step` and
`jit_spmd_multi_step`, JAX's jitted `spmd_step` and `spmd_multi_step`
with the state donated, replay this shard's step as a CUDA graph through
`solver/graph.py` on a single shard or an nccl mesh, with the cadence
unrolled (`_local_step`'s `volume_step`).

Communication per step (n shards, grid (X, Y, Z), detailed (DX, DY, DZ)):
one plane pair per radius-1 stage, k planes per Jacobi pass
(ceil(iters / k) passes), steps + 1 detailed planes for K5; then, with
index sharding, an all_gather of the velocity (3 X Y Z f32) and a
psum_scatter of the detailed occupancy (DX DY DZ u8); with domain
sharding, one velocity plane a side, two (m, 3) f32 migration buffers and
their (m,) int32 flags a direction, and a psum of the drop count.
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.state import NOWHERE, FluidState
from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.kernels import fuse_grid_choice, grid_fused
from tpu_fluid_torch.kernels import kernel_choice, store
from tpu_fluid_torch.kernels import surface_fused as k5
from tpu_fluid_torch.kernels.advect import (advect_all_halo_cuda,
                                            advect_from_types_halo_plain)
from tpu_fluid_torch.ops.scatter import particle_cell_histogram
from tpu_fluid_torch.ops.stencil import AXIS_MOVES, MOVES, neighbor_sum
from tpu_fluid_torch.ops.stencil import shifted
from tpu_fluid_torch.parallel.halo import (all_gather_x, halo_extend,
                                           halo_inner, halo_planes, psum,
                                           psum_scatter_x)
from tpu_fluid_torch.parallel.mesh import Mesh
from tpu_fluid_torch.parallel.particles_domain import (
    cell_histogram_local, detailed_occupancy_local, migrate,
    migrate_capacity, move_particles_local)
from tpu_fluid_torch.solver import graph
from tpu_fluid_torch.stages import celltypes, particles, pressure
from tpu_fluid_torch.stages import surface_fields
from tpu_fluid_torch.stages import velocity as vstages
from tpu_fluid_torch.stages.volume import density_drift, volume_due
from tpu_fluid_torch.surface.levelset import levelset_fields
from tpu_fluid_torch.utils import profiling


# --------------------------------------------------------------- cell types
def _update_air_spmd(types: torch.Tensor, cfg: FluidConfig, x0: int,
                     mesh: Mesh, extra_solid=None,
                     out=None) -> torch.Tensor:
    """Stage 03 on a local slab: the water-neighbour test reads one halo
    plane; the SOLID rule (JAX's `_solid_mask_spmd`) is global, and a
    scene's solid slab adds its cells.  Written into `out` where
    given."""
    water = types == CellType.WATER
    we = halo_extend(water, 1, mesh)
    around = torch.zeros_like(we)
    for mv in MOVES:
        around = around | shifted(we, mv, fill=False)
    air = (~water) & halo_inner(around)
    wet = torch.where(air, torch.full_like(types, CellType.AIR), types)
    solid = celltypes.solid_mask(types.shape, cfg, types.device, x0,
                                 cfg.grid_size[0])
    if extra_solid is not None:
        solid = solid | (extra_solid != 0)
    return torch.where(solid, torch.full_like(types, CellType.SOLID), wet,
                       out=out)


# ------------------------------------------------------------------- forces
def _forces_spmd(types: torch.Tensor, vel: torch.Tensor, cfg: FluidConfig,
                 x0: int, mesh: Mesh, force_field=None) -> torch.Tensor:
    """Stage 08 on a local slab (`stages/velocity.apply_forces`): the
    fountain and force cells are global cells; a scene's force slab tests
    the wetness of x faces on one halo plane."""
    lx, gy, gz = types.shape
    water = types == CellType.WATER
    wet_face = water | shifted(water, (0, -1, 0), fill=False)
    ynz = (torch.arange(gy, device=types.device) != 0).reshape(1, -1, 1)
    force = torch.where(wet_face & ynz, cfg.gravity, 0.0).to(vel.dtype)

    def cell_mask(cell):
        at = torch.zeros(types.shape, dtype=torch.bool, device=vel.device)
        if x0 <= cell[0] < x0 + lx:
            # fill_ on a view: an item assignment copies a host scalar,
            # which a CUDA graph cannot capture
            at[(cell[0] - x0,) + tuple(cell[1:])].fill_(True)
        return at

    force = force + torch.where(cell_mask(cfg.fountain) & wet_face,
                                cfg.fountain_force, 0.0).to(vel.dtype)
    out = vel.clone()
    out[1] = vel[1] + cfg.dt * force
    if cfg.extra_forces or force_field is not None:
        water_e = halo_extend(water, 1, mesh)
    for cell, fvec in cfg.extra_forces:
        at = cell_mask(cell)
        for c in range(3):
            if fvec[c] == 0.0:
                continue
            mv = tuple(-1 if k == c else 0 for k in range(3))
            wet_c = water | halo_inner(shifted(water_e, mv, fill=False))
            out[c] = out[c] + torch.where(at & wet_c, cfg.dt * fvec[c],
                                          0.0).to(vel.dtype)
    if force_field is not None:
        for c in range(3):
            mv = tuple(-1 if k == c else 0 for k in range(3))
            wet_c = water | halo_inner(shifted(water_e, mv, fill=False))
            out[c] = out[c] + torch.where(wet_c, cfg.dt * force_field[c],
                                          0.0).to(vel.dtype)
    return out


# ------------------------------------------------------------------ advect
def _advect_spmd(types: torch.Tensor, vel: torch.Tensor, cfg: FluidConfig,
                 x0: int, mesh: Mesh, use_kernels: bool) -> torch.Tensor:
    """Stage 07 on a local slab.  "auto" and "pallas" take K1's halo form
    (one launch for all three components, JAX's advect_all_pallas and
    advect_one_pallas routes); "shift" runs `advect_shift` on an
    (R + 1)-extended block.  "gather" has no sharded form and takes the
    shift path, as in JAX."""
    r = cfg.advect_max_displacement
    gx = cfg.grid_size[0]
    if cfg.advect_method in ("auto", "pallas"):
        # the masks read the type plane above the slab
        types_e = halo_extend(types, 1, mesh)
        halo = halo_planes(vel, r, mesh)
        advect = (advect_all_halo_cuda if use_kernels
                  else advect_from_types_halo_plain)
        # the unfused stages leave the slab a strided view (halo_inner of
        # dim 1); the kernel takes a contiguous one
        return advect(vel.contiguous(), types_e, r, cfg.dt, halo, x0,
                      (gx,) + tuple(types.shape[1:]))
    if cfg.advect_method not in ("shift", "gather"):
        raise ValueError(f"unknown advect_method {cfg.advect_method!r}")
    h = r + 1
    out = vstages.advect_shift(halo_extend(types, h, mesh),
                               halo_extend(vel, h, mesh), cfg, x0=x0 - h,
                               gx_total=gx)
    return halo_inner(out, h)


# -------------------------------------------------------------- surface
def _surface_kw(cfg: FluidConfig) -> dict:
    return dict(steps=cfg.float_density_diffuse_steps,
                k=cfg.float_density_diffuse_coefficient,
                inc_filled=cfg.inertia_increase_filled,
                inc_neigh=cfg.inertia_increase_neighbour,
                required_hits=cfg.inertia_required_neighbour_hits,
                dec=cfg.inertia_decrease, max_inertia=cfg.max_inertia,
                div_coef=cfg.float_density_division_coefficient)


def _surface_per_pass(occ, inertia, f2, skip, cfg, mesh):
    """Stages 16-18 for a detailed slab narrower than K5's halo: one plane
    exchanged a stage, in K5's arithmetic (`kernels/surface_fused.py`)."""
    kw = _surface_kw(cfg)
    steps = kw.pop("steps")
    new, a, _ = k5.surface_fused_plain(halo_extend(occ, 1, mesh),
                                       halo_extend(inertia, 1, mesh),
                                       halo_extend(f2, 1, mesh),
                                       halo_extend(skip, 1, mesh),
                                       steps=0, **kw)
    new, a = halo_inner(new), halo_inner(a)
    b = f2
    c0, c1 = k5._blur_constants(kw["k"])
    keep = skip != 0
    for it in range(steps):
        src, dst = (a, b) if it % 2 == 0 else (b, a)
        nsum = halo_inner(neighbor_sum(halo_extend(src, 1, mesh),
                                       moves=AXIS_MOVES))
        res = torch.where(keep, dst, c0 * src + c1 * nsum)
        if it % 2 == 0:
            b = res
        else:
            a = res
    return new, a, b


# -------------------------------------------------------------- local step
def _levelset_spmd(types: torch.Tensor, occ: torch.Tensor, cfg: FluidConfig,
                   x0: int, mesh: Mesh) -> torch.Tensor:
    """The level set (`surface/levelset.py`) of this shard's detailed slab.
    Its band reaches sweeps + smooth detailed cells, so it is computed on
    a block extended by ht = ceil((sweeps + smooth) / r) sim planes a side
    and cut back; where ht exceeds the slab, on the gathered grids, then
    sliced.  Either way the rows equal the single-device field's."""
    r = cfg.surface_render_resolution
    lx = types.shape[0]
    ht = -(-(cfg.levelset_sweeps_value + cfg.levelset_smooth) // r)
    if ht <= lx:
        f, _ = levelset_fields(halo_extend(types, ht, mesh),
                               halo_extend(occ, ht * r, mesh), cfg)
        return halo_inner(f, ht * r)
    f, _ = levelset_fields(all_gather_x(types, mesh, axis=0),
                           all_gather_x(occ, mesh, axis=0), cfg)
    return f[x0 * r:(x0 + lx) * r]


def _volume_drift_spmd(state: FluidState, types: torch.Tensor,
                       cfg: FluidConfig, x0: int, mesh: Mesh) -> torch.Tensor:
    """The volume drift on this shard's slab: the slab's particle counts
    (index sharding: every shard's counts over the whole grid, summed onto
    the slabs; domain sharding: the slab's own particles, no collective),
    then the sharded solve and the drift stencil with one halo plane."""
    lx = types.shape[0]
    if cfg.particle_sharding == "domain":
        counts = cell_histogram_local(state.positions, state.active,
                                      cfg.grid_size, x0, lx)
    else:
        counts = psum_scatter_x(particle_cell_histogram(
            state.positions, state.active, cfg.grid_size), mesh)
    return density_drift(counts, types, cfg, mesh=mesh, x0=x0)


def _local_step(state: FluidState, cfg: FluidConfig, mesh: Mesh,
                scene=None, volume_step: int | None = None,
                into: FluidState | None = None) -> FluidState:
    """One frame on this shard's slabs, in the single-device stage order
    (`solver/step.simulation_step`).  `scene` holds this shard's slabs of
    the SceneFields, if any.  `volume_step` is the caller's value of
    `state.step` for the volume cadence, and `into` the tensors the new
    fields are written into, as in `simulation_step` (the CUDA graphs
    pass both); without `volume_step` the step reads `state.step` on the
    host.  With tracing on (`utils/profiling`), the stage groups of
    `simulation_step`, by the same names, tile the step, each a span."""
    put = into if into is not None else NOWHERE
    device = state.velocity.device
    use_kernels = kernel_choice(cfg, device)
    gx = cfg.grid_size[0]
    lx = gx // mesh.size
    x0 = mesh.rank * lx
    fuse_grid = fuse_grid_choice(cfg, device, scene) and lx >= 2
    scene_solid = scene.solid if scene is not None else None
    scene_force = scene.force if scene is not None else None
    if use_kernels:
        classify_extrap = grid_fused.classify_extrap_halo_cuda
        forces_solids_div = grid_fused.forces_solids_div_halo_cuda
        project = grid_fused.project_halo_cuda
    else:
        classify_extrap = grid_fused.classify_extrap_halo_plain
        forces_solids_div = grid_fused.forces_solids_div_halo_plain
        project = grid_fused.project_halo_plain

    old_types = state.cell_types
    vel = state.velocity
    stage = profiling.stages()

    if fuse_grid:
        stage("01-06 classify and extrapolate (K6a)")
    else:
        stage("01-03 pool and cell typing")
    # 01
    occ_sim = particles.occupancy_to_sim_grid(state.detailed_occ, cfg)

    if fuse_grid:
        # 02-06 (K6a) with 2-plane halos
        halos = tuple(halo_planes(a, grid_fused.CLASSIFY_HALO, mesh)
                      for a in (occ_sim, old_types, vel))
        types, vel = classify_extrap(occ_sim, old_types, vel, cfg,
                                     halos=halos, x0=x0, global_gx=gx,
                                     out=(put.cell_types, None))
    else:
        new_types = celltypes.update_water(occ_sim)
        new_types = _update_air_spmd(new_types, cfg, x0, mesh,
                                     extra_solid=scene_solid,
                                     out=put.cell_types)
        stage("04+05 extrapolate")
        # 04-05 on 1-plane halo blocks, interior kept
        ot_e = halo_extend(old_types, 1, mesh)
        nt_e = halo_extend(new_types, 1, mesh)
        vel_e = halo_extend(vel, 1, mesh)
        extr_e = vstages.compute_extrapolated_velocities(ot_e, vel_e)
        vel = halo_inner(vstages.set_extrapolated_velocities(
            ot_e, nt_e, vel_e, extr_e))
        types = celltypes.commit_cell_types(new_types)

    stage("07 advect")
    vel = _advect_spmd(types, vel, cfg, x0, mesh, use_kernels)

    if fuse_grid:
        stage("08-11 forces, solids, divergence (K6b)")
        # 08-11 (K6b) with 1-plane halos
        halos = (halo_planes(types, 1, mesh), halo_planes(vel, 1, mesh))
        vel, div = forces_solids_div(types, vel, cfg, halos=halos, x0=x0,
                                     global_gx=gx)
    else:
        stage("08-10 forces/solids")
        vel = _forces_spmd(types, vel, cfg, x0, mesh,
                           force_field=scene_force)
        if not cfg.reference_diffuse_noop:
            vel = halo_inner(vstages.diffuse(halo_extend(types, 1, mesh),
                                             halo_extend(vel, 1, mesh), cfg))
        vel = halo_inner(vstages.apply_solids(halo_extend(types, 1, mesh),
                                              halo_extend(vel, 1, mesh), cfg))
        stage("11 divergence")
        # 11: the out-of-domain halo rows read 0, as the single-device
        # zero fill does; the i_c != 0 row they spoil is a halo row
        div = halo_inner(pressure.compute_divergence(
            halo_extend(vel, 1, mesh)))

    stage(f"12 jacobi x{cfg.jacobi_iters}")
    p = pressure.jacobi_solve(types, div, cfg, mesh=mesh)
    if fuse_grid:
        stage("13 project (K6c)")
        halos = (halo_planes(types, 1, mesh), halo_planes(p, 1, mesh),
                 halo_planes(vel, 1, mesh))
        vel = project(types, p, vel, cfg, halos=halos, x0=x0, global_gx=gx,
                      out=put.velocity)
    else:
        stage("13 project")
        vel = torch.stack([halo_inner(c) for c in pressure.project_components(
            halo_extend(types, 1, mesh), halo_extend(p, 1, mesh),
            halo_extend(vel, 1, mesh), cfg)], out=put.velocity)

    # 14-15, moving through vel plus the volume drift on a corrected
    # step.  Every shard holds the same step, so all take the same branch
    # and run the same collectives.  The drift is added to the slab before
    # any gather.
    stage("14+15 move and scatter")
    move_vel = vel
    if cfg.volume_correction > 0.0:
        if volume_step is None and cfg.volume_correction_every > 1:
            volume_step = int(state.step)
        if volume_due(cfg, volume_step or 0):
            move_vel = vel + _volume_drift_spmd(state, types, cfg, x0, mesh)
    if cfg.particle_sharding == "domain":
        # each shard moves the particles of its slab, hands the border
        # crossers to its neighbours in the moved rows and scatters onto
        # its detailed slab; one shard passes the active flags through
        pos = move_particles_local(move_vel, state.positions, state.active,
                                   cfg, x0, mesh, out=put.positions)
        with profiling.span("exchange.migrate"):
            pos, active, ndrop = migrate(
                pos, state.active, x0, lx,
                migrate_capacity(pos.shape[0], cfg), mesh,
                out=(pos, put.active if mesh.size > 1 else None))
        dropped = torch.add(state.dropped, psum(ndrop, mesh),
                            out=put.dropped)
        r = cfg.surface_render_resolution
        occ = detailed_occupancy_local(pos, active, cfg, x0 * r, lx * r,
                                       out=put.detailed_occ)
    else:
        # particles split by index: every shard gathers the velocity field,
        # moves its particles, scatters their occupancy over the whole
        # detailed grid (one K3+K4 launch on the card); the sum over shards
        # lands on the x-slabs
        active, dropped = state.active, state.dropped
        # K3+K4 takes a contiguous field, and one shard's gather returns
        # the slab as it is: the unfused stages leave it a strided view
        vel_full = all_gather_x(move_vel.contiguous(), mesh, axis=1)
        pos, occ_full = particles.move_and_scatter(
            vel_full, state.positions, active, cfg, out=(put.positions, None))
        summed = psum_scatter_x(occ_full, mesh)
        if put.detailed_occ is None:
            occ = (summed > 0).to(torch.uint8)
        else:
            occ = put.detailed_occ
            torch.gt(summed, 0, out=occ.view(torch.bool))

    stage("16-18 surface fields")
    if cfg.surface_enabled and cfg.surface_method == "levelset":
        inertia = state.inertia
        f = _levelset_spmd(types, occ, cfg, x0, mesh)
        f1, f2 = store(f, put.float_dens_1), store(f, put.float_dens_2)
    elif cfg.surface_enabled:
        steps = cfg.float_density_diffuse_steps
        h = steps + 1
        skip = surface_fields.solid_parent_mask(types, cfg).to(torch.uint8)
        if occ.shape[0] >= h:
            # K5's halo form: one (steps + 1)-plane exchange of each input
            fused = (k5.surface_fused_halo_cuda if use_kernels
                     else k5.surface_fused_halo_plain)
            r = cfg.surface_render_resolution
            halos = tuple(halo_planes(a, h, mesh) for a in (
                occ, state.inertia, state.float_dens_2, skip))
            kw = _surface_kw(cfg)
            inertia, f1, f2 = fused(
                occ, state.inertia, state.float_dens_2, skip, halos=halos,
                x0=x0 * r, global_gx=gx * r,
                out=(put.inertia, put.float_dens_1, put.float_dens_2), **kw)
        else:
            inertia, f1, f2 = store(_surface_per_pass(
                occ, state.inertia, state.float_dens_2, skip, cfg, mesh),
                (put.inertia, put.float_dens_1, put.float_dens_2))
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
        active=active,
        detailed_occ=occ,
        step=counter,
        dropped=dropped,
    )


# ------------------------------------------------------------ entry points
def validate_spmd_config(cfg: FluidConfig, n_shards: int) -> None:
    """Raise ValueError where the layout cannot hold the config."""
    gx = cfg.grid_size[0]
    if gx % n_shards:
        raise ValueError(f"grid x size {gx} must divide the mesh "
                         f"({n_shards} shards)")
    if cfg.particle_sharding == "domain":
        # every shard allocates the same slots (domain_shard_state), and
        # the local move samples a slab-local packed table
        if cfg.particle_sampler != "packed":
            raise ValueError("particle_sharding='domain' requires the "
                             "packed sampler")
    elif cfg.particle_sharding != "index":
        raise ValueError(f"unknown particle_sharding "
                         f"{cfg.particle_sharding!r}")
    elif cfg.particle_count % n_shards:
        raise ValueError(f"particle_count {cfg.particle_count} must divide "
                         f"the mesh ({n_shards} shards)")
    lx = gx // n_shards
    if lx < cfg.advect_max_displacement + 1:
        raise ValueError(f"local slab width {lx} too small for advection "
                         f"halo {cfg.advect_max_displacement + 1}")


def spmd_step(cfg: FluidConfig, mesh: Mesh, scene=None):
    """This shard's step: a function local_state -> local_state over the
    slabs `mesh.shard_state` cuts (`particles_domain.domain_shard_state`
    with domain-sharded particles), run with autograd off.  Every shard of
    the mesh calls its own in lockstep.  `scene` is this shard's part of a
    SceneFields (`mesh.shard_scene`)."""
    validate_spmd_config(cfg, mesh.size)

    @torch.no_grad()
    def step(state: FluidState) -> FluidState:
        return _local_step(state, cfg, mesh, scene)

    return step


def spmd_multi_step(cfg: FluidConfig, mesh: Mesh, n_steps: int,
                    scene=None):
    """n_steps frames per call, a loop over `spmd_step`."""
    step = spmd_step(cfg, mesh, scene)

    def multi(state: FluidState) -> FluidState:
        for _ in range(n_steps):
            state = step(state)
        return state

    return multi


def spmd_program(cfg: FluidConfig, mesh: Mesh) -> graph.Program:
    """This shard's step as a `solver/graph.Program`, keyed on the mesh's
    rank, size, backend and device.  On an nccl group the capture is
    thread-local: the group's watchdog thread queries events while a
    graph is being captured."""
    validate_spmd_config(cfg, mesh.size)
    if mesh.host_staged:
        raise ValueError(
            "a CUDA graph cannot capture a copy through the host: the "
            "graphed sharded step needs a single shard or an nccl mesh; a "
            "gloo mesh on the card runs the eager spmd_step")

    def local(state, cfg_, scene, volume_step, into=None):
        return _local_step(state, cfg_, mesh, scene, volume_step, into)

    return graph.Program(
        local, ("spmd", mesh.rank, mesh.size, mesh.backend, mesh.device),
        "thread_local" if mesh.backend == "nccl" else "global")


def jit_spmd_multi_step(cfg: FluidConfig, mesh: Mesh, n_steps: int,
                        scene=None):
    """n_steps frames per call, JAX's jitted `spmd_multi_step` with the
    state donated: a function local_state -> local_state that replays
    this shard's CUDA graph of n_steps steps (`solver/graph.py`: a
    returned state is consumed when passed back in).  On CPU states it
    runs the eager `spmd_step` n_steps times.  Every shard of the mesh
    calls its own in lockstep.  A gloo mesh on the card (host-staged)
    raises: its eager `spmd_step` is the route there."""
    program = spmd_program(cfg, mesh)

    def multi(state: FluidState) -> FluidState:
        return graph.replay(state, cfg, n_steps, scene, program)

    return multi


def jit_spmd_step(cfg: FluidConfig, mesh: Mesh, scene=None):
    """One frame per call: `jit_spmd_multi_step(cfg, mesh, 1, scene)`,
    JAX's jitted `spmd_step` with the state donated."""
    return jit_spmd_multi_step(cfg, mesh, 1, scene)
