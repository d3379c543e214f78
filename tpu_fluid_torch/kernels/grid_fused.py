"""K6: the fused sim-grid stage groups, on when `fuse_grid_choice` picks
them (`FluidConfig.scaled_scene(n)` sets `grid_fused` for n >= 256).

  classify_extrap_cuda      stages 01-06 (K6a; 01 the occupancy max-pool)
  forces_solids_div_cuda    stages 08, 10 and 11 (K6b; 09 is the no-op)
  project_cuda              stage 13 (K6c)

Replace `tpu_fluid/kernels/grid_fused.py:classify_extrap_pallas`,
`forces_solids_div_pallas` and `project_pallas` (bodies
`_classify_extrap_kernel`, `_forces_solids_div_kernel`, `_project_kernel`,
all launched by `_call`); CUDA source `csrc/grid_fused.cu`.  K6a also
takes in stage 01, `tpu_fluid/stages/particles.py:occupancy_to_sim_grid`:
given the detailed occupancy and `pool` (the surface render resolution),
it max-pools each pool^3 block itself.  The TPU kernels fuse each group
over VMEM x-slabs with 2- or 1-row halos; on the card K6a and K6b march
32 x 32 y-z tiles with 2- and 1-cell halos along x
(`tiling.grid_fused_pass`), computing each cell's new type (K6a) or forced
velocity (K6b) once and passing it to its neighbours through shared
memory; K6c marches 16 x 64 tiles with a low ring (`tiling.project_pass`),
since stage 13 reads only lower neighbours.  Each group is one pass over
its fields instead of the dozens of elementwise passes of the stage
functions.

The plain versions follow the kernel bodies' arithmetic, not the stage
functions' selects: 0/1 float indicators, `(1-gone)*(born*extr +
(1-born)*vel)`, `solid*min(v,-repel) + (1-solid)*v`, sums from zero in
`MOVES` order.  The two forms differ at most in the sign of a zero.  Every
Python-float constant meets the field as f32, as in the JAX kernels; an
extra force's `dt * f` is formed in double and rounded once.  K6a's plain
version at pool > 1 is the stage-01 max-pool followed by the pool-1 plain
version.

The halo forms (`classify_extrap_halo_cuda`, `forces_solids_div_halo_cuda`,
`project_halo_cuda`, each beside its plain version) replace the sharded
calls of the three JAX kernels (`halos`, `x0`, `global_gx`;
`tpu_fluid/parallel/spmd_step.py:232-290`): the local slab of global rows
[x0, x0 + lx) with 2 neighbour planes a side for K6a and 1 for K6b and
K6c, zeros past the domain.  K6c reads of them only the left planes of
the types and pressure, through their own pointers (no copy of the slab);
the wrapper takes and checks all three pairs, as JAX's does.
Coordinates, the SOLID rule, the force cells and the out-of-domain zero
are global, so each row equals the single-device row.  K6a's halo form
takes the pooled sim-grid occupancy (the sharded step pools its slab in
plain torch).
"""

from __future__ import annotations

import functools

import torch

from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.kernels import build, on_cuda, require, store, tiling
from tpu_fluid_torch.kernels.tiling import CLASSIFY_HALO, FORCES_HALO
from tpu_fluid_torch.ops.stencil import MOVES, axis_nonzero, shifted
from tpu_fluid_torch.stages.celltypes import update_air, update_water
from tpu_fluid_torch.stages.particles import pool_occupancy

_CLASSIFY_ARGTYPES = ((build.POINTER,) * 5 + (build.INT,) * 9
                      + (build.POINTER, build.INT, build.POINTER))
_FORCES_ARGTYPES = ((build.POINTER,) * 4 + (build.INT,) * 8
                    + (build.FLOAT,) * 2 + (build.INT,) * 3
                    + (build.FLOAT,) * 2
                    + (build.POINTER, build.POINTER, build.INT,
                       build.POINTER))
_PROJECT_ARGTYPES = ((build.POINTER,) * 6 + (build.INT,) * 6
                     + (build.FLOAT, build.POINTER))

# Halo planes a side of the halo forms: each kernel's own halo (K6a's
# stage 05 reads new types of x +- 1, whose AIR test reads occupancy at
# x +- 2; K6b's divergence reads the forced velocity of x + 1, which reads
# the types of x), and 1 for K6c.
PROJECT_HALO = 1


def _f32(x: float) -> float:
    """A Python float rounded to f32, as JAX rounds a weakly typed
    constant where it meets an f32 array."""
    return float(torch.tensor(x, dtype=torch.float32))


def _lower(a: torch.Tensor, c: int, fill=0) -> torch.Tensor:
    """a at i - e_c, `fill` outside the grid."""
    return shifted(a, tuple(-1 if k == c else 0 for k in range(3)), fill)


def _upper(a: torch.Tensor, c: int) -> torch.Tensor:
    return shifted(a, tuple(1 if k == c else 0 for k in range(3)))


def _sum6(a: torch.Tensor) -> torch.Tensor:
    """Sum of the 6 zero-padded neighbours, from zero, in MOVES order."""
    out = torch.zeros_like(a)
    for mv in MOVES:
        out = out + shifted(a, mv)
    return out


def _cell_indicator(shape, cell, device, xb: int = 0) -> torch.Tensor:
    """f32 1 at `cell` (if it lies in the slab whose row 0 is global x
    xb), 0 elsewhere."""
    ind = torch.zeros(shape, dtype=torch.float32, device=device)
    local = (cell[0] - xb,) + tuple(cell[1:])
    if all(0 <= i < n for i, n in zip(local, shape)):
        ind[local].fill_(1.0)     # no host scalar: capturable
    return ind


def _in_domain(rows: int, xb: int, gx: int, device) -> torch.Tensor:
    """(rows, 1, 1) mask of the slab rows inside the global domain."""
    x = torch.arange(xb, xb + rows, device=device)
    return ((x >= 0) & (x < gx)).reshape(-1, 1, 1)


def _check_halos(arrays, halos, h) -> None:
    """Each (left, right) pair of `halos` holds h-plane halos on the x
    axis of its local slab (X, Y, Z) or (3, X, Y, Z)."""
    for a, pair in zip(arrays, halos):
        shape = list(a.shape)
        shape[a.ndim - 3] = h
        for plane in pair:
            require(plane, "halo plane", a.dtype, shape, a.device)


def _with_halos(arrays, halos, h):
    """Each local slab (X, Y, Z) or (3, X, Y, Z) with its (left, right)
    h-plane halos on the x axis."""
    _check_halos(arrays, halos, h)
    return [torch.cat([left, a, right], dim=a.ndim - 3)
            for a, (left, right) in zip(arrays, halos)]


def _check_global(shape, global_gx, x0):
    if not 0 <= x0 <= global_gx - shape[0]:
        raise ValueError(f"slab of {shape[0]} rows at x0 = {x0} outside a "
                         f"domain of {global_gx}")


def _force_terms(cfg) -> list[tuple[tuple[int, int, int], int, float]]:
    """The extra cell forces as (cell, component, dt * f) terms, in config
    order, zero components left out as the JAX kernel leaves them out."""
    return [(tuple(cell), c, cfg.dt * fvec[c])
            for cell, fvec in cfg.extra_forces
            for c in range(3) if fvec[c] != 0.0]


@functools.lru_cache(maxsize=64)
def _device_table(rows: tuple, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """A small constant table (solid boxes, force terms) on the device,
    made once per config and device."""
    return torch.tensor(rows, dtype=dtype, device=device).contiguous()


# ----------------------------------------------------------- stages 02-06
def _active(t: torch.Tensor) -> torch.Tensor:
    return ((t == CellType.WATER) | (t == CellType.AIR)).to(torch.float32)


def _classify_extrap(occ_sim, old_types, vel, cfg, xb, gx):
    """K6a's arithmetic on a slab whose row 0 lies at global x xb of a
    domain gx rows wide; rows outside the domain are INACTIVE."""
    newt = update_air(update_water(occ_sim), cfg, x0=xb, global_gx=gx)
    if xb < 0 or xb + newt.shape[0] > gx:
        newt = torch.where(_in_domain(newt.shape[0], xb, gx, newt.device),
                           newt, torch.zeros_like(newt))
    old_w = (old_types == CellType.WATER).to(torch.float32)
    denom = torch.clamp(_sum6(old_w), min=1.0)
    vsum = _sum6(vel * old_w)
    was, is_ = _active(old_types), _active(newt)
    comps = []
    for c in range(3):
        extr = vsum[c] / denom
        was_c = torch.clamp(was + _lower(was, c), max=1.0)
        is_c = torch.clamp(is_ + _lower(is_, c), max=1.0)
        gone = was_c * (1.0 - is_c)
        born = (1.0 - was_c) * is_c
        comps.append((1.0 - gone) * (born * extr + (1.0 - born) * vel[c]))
    return newt, torch.stack(comps)


def classify_extrap_plain(occ, old_types, vel, cfg, *, pool=1, out=None):
    """(occ u8 at `pool` times the sim grid, old_types u8, vel f32
    (3,X,Y,Z)) -> (types u8, vel'): stage 01's max-pool, then stages
    02-06, copied into `out`'s (types, vel) where given.  The new types
    are integer codes, so the stage functions give them exactly as the
    kernel body's indicator arithmetic does."""
    occ_sim = pool_occupancy(occ, pool) if pool > 1 else occ
    return store(_classify_extrap(occ_sim, old_types, vel, cfg, 0,
                                  occ_sim.shape[0]), out)


def classify_extrap_halo_plain(occ_sim, old_types, vel, cfg, *, halos, x0,
                               global_gx, out=None):
    """The halo form: local slabs of global rows [x0, x0 + lx), `halos`
    the ((left, right), ...) 2-plane halos of (occ_sim, old_types, vel)."""
    h = CLASSIFY_HALO
    _check_global(occ_sim.shape, global_gx, x0)
    ext = _with_halos((occ_sim, old_types, vel), halos, h)
    newt, v = _classify_extrap(*ext, cfg, x0 - h, global_gx)
    return store((newt[h:-h], v[:, h:-h]), out)


def _check_vel(vel):
    require(vel, "vel", torch.float32)
    if vel.ndim != 4 or vel.shape[0] != 3:
        raise ValueError(f"vel: shape {tuple(vel.shape)}, expected (3,X,Y,Z)")
    return tuple(vel.shape[1:])


def _check_classify_out(out, vel):
    """K6a's `out`: (types, vel) tensors or None entries."""
    if out is None:
        return (None, None)
    types, v = out
    if types is not None:
        require(types, "out types", torch.uint8, vel.shape[1:], vel.device)
    if v is not None:
        require(v, "out vel", torch.float32, vel.shape, vel.device)
    return out


def _boxes_ptr(cfg, device):
    boxes = tuple(tuple(lo) + tuple(hi) for lo, hi in cfg.solid_boxes)
    table = (_device_table(boxes, torch.int32, device).data_ptr()
             if boxes else None)
    return table, len(boxes)


def device_launches() -> int:
    """Kernels the C entry points of `csrc/grid_fused.cu` have launched."""
    return build.launches("tf_grid_fused_launches")


def _grid_pass(shape, halo, slab_halo, device):
    return tiling.grid_fused_pass(shape, halo, slab_halo=slab_halo,
                                  sms=build.sm_count(device.index))


def _classify_launch(occ, old_types, vel, cfg, xb, gx, h, pool, to):
    """K6a on inputs of nx rows (h neighbour planes a side, row 0 at global
    x xb of a domain gx rows wide); returns the interior rows, in `to`'s
    (types, vel) where given."""
    nx, gy, gz = old_types.shape
    with torch.cuda.device(vel.device):
        p = _grid_pass(old_types.shape, CLASSIFY_HALO, h, vel.device)
        shape = (p.xe - p.xs, gy, gz)
        types, out = to
        if types is None:
            types = torch.empty(shape, dtype=torch.uint8, device=vel.device)
        if out is None:
            out = torch.empty((3,) + shape, dtype=vel.dtype,
                              device=vel.device)
        table, nbox = _boxes_ptr(cfg, vel.device)
        stream = torch.cuda.current_stream(vel.device).cuda_stream
        build.call("tf_classify_extrap", _CLASSIFY_ARGTYPES,
                   occ.data_ptr(), old_types.data_ptr(), vel.data_ptr(),
                   types.data_ptr(), out.data_ptr(), nx, gy, gz, xb, gx,
                   p.xs, p.xe, p.seg, pool, table, nbox, stream)
    return types, out


def classify_extrap_cuda(occ, old_types, vel, cfg, *, pool=1, out=None):
    """K6a wrapper (arguments as `classify_extrap_plain`; `out` the
    (types, vel) tensors to write, None entries allocated): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    shape = _check_vel(vel)
    if not isinstance(pool, int) or pool < 1:
        raise ValueError(f"pool = {pool!r}, expected an int >= 1")
    require(occ, "occ", torch.uint8, tuple(pool * n for n in shape),
            vel.device)
    if pool == 2 and occ.data_ptr() % 2:
        raise ValueError("occ: at pool 2 the kernel reads it as u16 pairs, "
                         "so it must start on a 2-byte boundary")
    require(old_types, "old_types", torch.uint8, shape, vel.device)
    to = _check_classify_out(out, vel)
    if not on_cuda(vel):
        return classify_extrap_plain(occ, old_types, vel, cfg, pool=pool,
                                     out=out)
    res = _classify_launch(occ, old_types, vel, cfg, 0, shape[0], 0, pool,
                           to)
    classify_extrap_cuda.launches += 1
    return res


classify_extrap_cuda.launches = 0


def classify_extrap_halo_cuda(occ_sim, old_types, vel, cfg, *, halos, x0,
                              global_gx, out=None):
    """K6a halo-form wrapper (arguments as `classify_extrap_halo_plain`):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    shape = _check_vel(vel)
    require(occ_sim, "occ_sim", torch.uint8, shape, vel.device)
    require(old_types, "old_types", torch.uint8, shape, vel.device)
    to = _check_classify_out(out, vel)
    if not on_cuda(vel):
        return classify_extrap_halo_plain(occ_sim, old_types, vel, cfg,
                                          halos=halos, x0=x0,
                                          global_gx=global_gx, out=out)
    _check_global(shape, global_gx, x0)
    h = CLASSIFY_HALO
    ext = _with_halos((occ_sim, old_types, vel), halos, h)
    res = _classify_launch(*ext, cfg, x0 - h, global_gx, h, 1, to)
    classify_extrap_halo_cuda.launches += 1
    return res


classify_extrap_halo_cuda.launches = 0


# ------------------------------------------------------- stages 08, 10, 11
def _forces_solids_div(types, vel, cfg, xb, gx):
    """K6b's arithmetic on a slab whose row 0 lies at global x xb of a
    domain gx rows wide; the velocity of rows outside the domain is 0
    where the divergence reads it."""
    shape, dev = tuple(types.shape), types.device
    water = (types == CellType.WATER).to(torch.float32)
    wet_y = torch.clamp(water + _lower(water, 1), max=1.0)
    ynz = 1.0 - (~axis_nonzero(shape, 1, dev)).to(torch.float32)
    force = wet_y * ynz * _f32(cfg.gravity)
    force = force + (_cell_indicator(shape, cfg.fountain, dev, xb) * wet_y
                     * _f32(cfg.fountain_force))
    vs = [vel[0], vel[1] + _f32(cfg.dt) * force, vel[2]]
    for cell, c, dtf in _force_terms(cfg):
        wet_c = torch.clamp(water + _lower(water, c), max=1.0)
        vs[c] = vs[c] + (_cell_indicator(shape, cell, dev, xb) * wet_c
                         * _f32(dtf))
    solid = (types == CellType.SOLID).to(torch.float32)
    repel = _f32(cfg.solid_repel_velocity)
    for c in range(3):
        v = solid * torch.clamp(vs[c], max=-repel) + (1.0 - solid) * vs[c]
        ls = _lower(solid, c)
        vs[c] = ls * torch.clamp(v, min=repel) + (1.0 - ls) * v
    if xb < 0 or xb + shape[0] > gx:
        dom = _in_domain(shape[0], xb, gx, dev)
        vs = [torch.where(dom, v, 0.0) for v in vs]
    div = torch.zeros(shape, dtype=vel.dtype, device=dev)
    for c in range(3):
        div = div + _upper(vs[c], c) - vs[c]
    return torch.stack(vs), div


def forces_solids_div_plain(types, vel, cfg):
    """(types u8, vel f32 (3,X,Y,Z)) -> (vel', div): forces, solid repel,
    then the divergence of the result (0 beyond the upper edges)."""
    return _forces_solids_div(types, vel, cfg, 0, types.shape[0])


def forces_solids_div_halo_plain(types, vel, cfg, *, halos, x0, global_gx):
    """The halo form: local slabs of global rows [x0, x0 + lx), `halos`
    the ((left, right), ...) 1-plane halos of (types, vel)."""
    h = FORCES_HALO
    _check_global(types.shape, global_gx, x0)
    ext = _with_halos((types, vel), halos, h)
    v, div = _forces_solids_div(*ext, cfg, x0 - h, global_gx)
    return v[:, h:-h], div[h:-h]


def _forces_launch(types, vel, cfg, xb, gx, h):
    """K6b on inputs of nx rows (h neighbour planes a side, row 0 at global
    x xb of a domain gx rows wide); returns the interior rows."""
    nx, gy, gz = types.shape
    terms = _force_terms(cfg)
    cells = tuple(cell + (c,) for cell, c, _ in terms)
    kterm = tuple(dtf for _, _, dtf in terms)
    with torch.cuda.device(vel.device):
        p = _grid_pass(types.shape, FORCES_HALO, h, vel.device)
        shape = (p.xe - p.xs, gy, gz)
        out = torch.empty((3,) + shape, dtype=vel.dtype, device=vel.device)
        div = torch.empty(shape, dtype=vel.dtype, device=vel.device)
        cells_ptr = (_device_table(cells, torch.int32, vel.device).data_ptr()
                     if terms else None)
        kterm_ptr = (_device_table(kterm, torch.float32, vel.device
                                   ).data_ptr() if terms else None)
        stream = torch.cuda.current_stream(vel.device).cuda_stream
        build.call("tf_forces_solids_div", _FORCES_ARGTYPES,
                   types.data_ptr(), vel.data_ptr(), out.data_ptr(),
                   div.data_ptr(), nx, gy, gz, xb, gx, p.xs, p.xe, p.seg,
                   cfg.dt, cfg.gravity, *cfg.fountain, cfg.fountain_force,
                   cfg.solid_repel_velocity, cells_ptr, kterm_ptr,
                   len(terms), stream)
    return out, div


def forces_solids_div_cuda(types, vel, cfg):
    """K6b wrapper: the CUDA kernel for CUDA tensors,
    `forces_solids_div_plain` for CPU tensors."""
    shape = _check_vel(vel)
    require(types, "types", torch.uint8, shape, vel.device)
    if not on_cuda(vel):
        return forces_solids_div_plain(types, vel, cfg)
    out = _forces_launch(types, vel, cfg, 0, shape[0], 0)
    forces_solids_div_cuda.launches += 1
    return out


forces_solids_div_cuda.launches = 0


def forces_solids_div_halo_cuda(types, vel, cfg, *, halos, x0, global_gx):
    """K6b halo-form wrapper (arguments as `forces_solids_div_halo_plain`):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    shape = _check_vel(vel)
    require(types, "types", torch.uint8, shape, vel.device)
    if not on_cuda(vel):
        return forces_solids_div_halo_plain(types, vel, cfg, halos=halos,
                                            x0=x0, global_gx=global_gx)
    _check_global(shape, global_gx, x0)
    h = FORCES_HALO
    ext = _with_halos((types, vel), halos, h)
    out = _forces_launch(*ext, cfg, x0 - h, global_gx, h)
    forces_solids_div_halo_cuda.launches += 1
    return out


forces_solids_div_halo_cuda.launches = 0


# --------------------------------------------------------------- stage 13
def _project_scale(cfg) -> float:
    """dt / (rho * dx) in double, as the JAX wrapper forms it."""
    return cfg.dt / (cfg.fluid_density * cfg.cell_width)


def _project(types, p, vel, cfg, xb):
    """K6c's arithmetic on a slab whose row 0 lies at global x xb."""
    water = types == CellType.WATER
    solid = types == CellType.SOLID
    scale = _f32(_project_scale(cfg))
    comps = []
    for c in range(3):
        nonzero = axis_nonzero(types.shape, c, types.device)
        if c == 0:
            nonzero = (torch.arange(types.shape[0], device=types.device)
                       + xb != 0).reshape(-1, 1, 1)
        cond = (nonzero & (water | _lower(water, c, False)) & ~solid
                & ~_lower(solid, c, False)).to(torch.float32)
        grad = p - _lower(p, c)
        comps.append(vel[c] - scale * (cond * grad))
    return torch.stack(comps)


def project_plain(types, p, vel, cfg, *, out=None):
    """(types u8, p f32, vel f32 (3,X,Y,Z)) -> vel - scale * (cond *
    (p - p(i - e_c))), copied into `out` where given."""
    return store(_project(types, p, vel, cfg, 0), out)


def project_halo_plain(types, p, vel, cfg, *, halos, x0, global_gx,
                       out=None):
    """The halo form: local slabs of global rows [x0, x0 + lx), `halos`
    the ((left, right), ...) 1-plane halos of (types, p, vel)."""
    h = PROJECT_HALO
    _check_global(types.shape, global_gx, x0)
    ext = _with_halos((types, p, vel), halos, h)
    return store(_project(*ext, cfg, x0 - h)[:, h:-h], out)


def _project_launch(types, p, vel, cfg, xb, gx, out, left=(None, None)):
    """K6c on slabs of nx rows whose row 0 lies at global x xb of a domain
    gx rows wide, into `out` (else a new tensor); `left` holds the types
    and pressure of global row xb - 1 where xb > 0."""
    nx, gy, gz = types.shape
    with torch.cuda.device(vel.device):
        plan = tiling.project_pass(types.shape,
                                   sms=build.sm_count(vel.device.index))
        if out is None:
            out = torch.empty_like(vel)
        stream = torch.cuda.current_stream(vel.device).cuda_stream
        build.call("tf_project", _PROJECT_ARGTYPES, types.data_ptr(),
                   p.data_ptr(), vel.data_ptr(),
                   *(None if t is None else t.data_ptr() for t in left),
                   out.data_ptr(), nx, gy, gz, xb, gx, plan.seg,
                   _project_scale(cfg), stream)
    return out


def _check_project(types, p, vel, out):
    shape = _check_vel(vel)
    require(types, "types", torch.uint8, shape, vel.device)
    require(p, "p", torch.float32, shape, vel.device)
    if out is not None:
        require(out, "out", torch.float32, vel.shape, vel.device)
    return shape


def project_cuda(types, p, vel, cfg, *, out=None):
    """K6c wrapper (`out` the velocity tensor to write, else a new one):
    the CUDA kernel for CUDA tensors, `project_plain` for CPU tensors."""
    shape = _check_project(types, p, vel, out)
    if not on_cuda(vel):
        return project_plain(types, p, vel, cfg, out=out)
    res = _project_launch(types, p, vel, cfg, 0, shape[0], out)
    project_cuda.launches += 1
    return res


project_cuda.launches = 0


def project_halo_cuda(types, p, vel, cfg, *, halos, x0, global_gx,
                      out=None):
    """K6c halo-form wrapper (arguments as `project_halo_plain`): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  The
    kernel reads the slabs and the left halo planes of the types and
    pressure; the right planes and the velocity's are checked, not
    read."""
    shape = _check_project(types, p, vel, out)
    if not on_cuda(vel):
        return project_halo_plain(types, p, vel, cfg, halos=halos, x0=x0,
                                  global_gx=global_gx, out=out)
    _check_global(shape, global_gx, x0)
    _check_halos((types, p, vel), halos, PROJECT_HALO)
    left = (halos[0][0], halos[1][0])
    res = _project_launch(types, p, vel, cfg, x0, global_gx, out, left)
    project_halo_cuda.launches += 1
    return res


project_halo_cuda.launches = 0
