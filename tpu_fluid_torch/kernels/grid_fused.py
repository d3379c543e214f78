"""K6: the fused sim-grid stage groups, on when `fuse_grid_choice` picks
them (`FluidConfig.scaled_scene(n)` sets `grid_fused` for n >= 256).

  classify_extrap_cuda      stages 02-06 (K6a)
  forces_solids_div_cuda    stages 08, 10 and 11 (K6b; 09 is the no-op)
  project_cuda              stage 13 (K6c)

Replace `tpu_fluid/kernels/grid_fused.py:classify_extrap_pallas`,
`forces_solids_div_pallas` and `project_pallas` (bodies
`_classify_extrap_kernel`, `_forces_solids_div_kernel`, `_project_kernel`,
all launched by `_call`); CUDA source `csrc/grid_fused.cu`.  The TPU
kernels fuse each group over VMEM x-slabs with 2- or 1-row halos; on the
card one thread computes one cell and recomputes what it needs of its
neighbours (the new types of i - e_c in K6a, the post-stage-10 velocity of
i + e_c in K6b).  Each group is one pass over its fields instead of the
dozens of elementwise passes of the stage functions.

The plain versions follow the kernel bodies' arithmetic, not the stage
functions' selects: 0/1 float indicators, `(1-gone)*(born*extr +
(1-born)*vel)`, `solid*min(v,-repel) + (1-solid)*v`, sums from zero in
`MOVES` order.  The two forms differ at most in the sign of a zero.  Every
Python-float constant meets the field as f32, as in the JAX kernels; an
extra force's `dt * f` is formed in double and rounded once.  Only the
single-device form is here: the halo and x-offset arguments go with the
multi-device step.
"""

from __future__ import annotations

import functools

import torch

from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.kernels import build, on_cuda, require
from tpu_fluid_torch.ops.stencil import MOVES, axis_nonzero, shifted
from tpu_fluid_torch.stages.celltypes import update_air, update_water

_CLASSIFY_ARGTYPES = ((build.POINTER,) * 5 + (build.INT,) * 3
                      + (build.POINTER, build.INT, build.POINTER))
_FORCES_ARGTYPES = ((build.POINTER,) * 4 + (build.INT,) * 3
                    + (build.FLOAT,) * 2 + (build.INT,) * 3
                    + (build.FLOAT,) * 2
                    + (build.POINTER, build.POINTER, build.INT,
                       build.POINTER))
_PROJECT_ARGTYPES = ((build.POINTER,) * 4 + (build.INT,) * 3
                     + (build.FLOAT, build.POINTER))


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


def _cell_indicator(shape, cell, device) -> torch.Tensor:
    """f32 1 at `cell` (if it lies in the grid), 0 elsewhere."""
    ind = torch.zeros(shape, dtype=torch.float32, device=device)
    if all(0 <= i < n for i, n in zip(cell, shape)):
        ind[tuple(cell)] = 1.0
    return ind


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


def classify_extrap_plain(occ_sim, old_types, vel, cfg):
    """(occ_sim u8, old_types u8, vel f32 (3,X,Y,Z)) -> (types u8, vel').
    The new types are integer codes, so the stage functions give them
    exactly as the kernel body's indicator arithmetic does."""
    newt = update_air(update_water(occ_sim), cfg)
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


def classify_extrap_cuda(occ_sim, old_types, vel, cfg):
    """K6a wrapper: the CUDA kernel for CUDA tensors,
    `classify_extrap_plain` for CPU tensors."""
    require(vel, "vel", torch.float32)
    if vel.ndim != 4 or vel.shape[0] != 3:
        raise ValueError(f"vel: shape {tuple(vel.shape)}, expected (3,X,Y,Z)")
    shape = tuple(vel.shape[1:])
    require(occ_sim, "occ_sim", torch.uint8, shape, vel.device)
    require(old_types, "old_types", torch.uint8, shape, vel.device)
    if not on_cuda(vel):
        return classify_extrap_plain(occ_sim, old_types, vel, cfg)
    types = torch.empty_like(old_types)
    out = torch.empty_like(vel)
    boxes = tuple(tuple(lo) + tuple(hi) for lo, hi in cfg.solid_boxes)
    table = (_device_table(boxes, torch.int32, vel.device).data_ptr()
             if boxes else None)
    with torch.cuda.device(vel.device):
        stream = torch.cuda.current_stream(vel.device).cuda_stream
        build.call("tf_classify_extrap", _CLASSIFY_ARGTYPES,
                   occ_sim.data_ptr(), old_types.data_ptr(), vel.data_ptr(),
                   types.data_ptr(), out.data_ptr(), *shape, table,
                   len(boxes), stream)
    classify_extrap_cuda.launches += 1
    return types, out


classify_extrap_cuda.launches = 0


# ------------------------------------------------------- stages 08, 10, 11
def forces_solids_div_plain(types, vel, cfg):
    """(types u8, vel f32 (3,X,Y,Z)) -> (vel', div): forces, solid repel,
    then the divergence of the result (0 beyond the upper edges)."""
    shape, dev = tuple(types.shape), types.device
    water = (types == CellType.WATER).to(torch.float32)
    wet_y = torch.clamp(water + _lower(water, 1), max=1.0)
    ynz = 1.0 - (~axis_nonzero(shape, 1, dev)).to(torch.float32)
    force = wet_y * ynz * _f32(cfg.gravity)
    force = force + (_cell_indicator(shape, cfg.fountain, dev) * wet_y
                     * _f32(cfg.fountain_force))
    vs = [vel[0], vel[1] + _f32(cfg.dt) * force, vel[2]]
    for cell, c, dtf in _force_terms(cfg):
        wet_c = torch.clamp(water + _lower(water, c), max=1.0)
        vs[c] = vs[c] + (_cell_indicator(shape, cell, dev) * wet_c
                         * _f32(dtf))
    solid = (types == CellType.SOLID).to(torch.float32)
    repel = _f32(cfg.solid_repel_velocity)
    for c in range(3):
        v = solid * torch.clamp(vs[c], max=-repel) + (1.0 - solid) * vs[c]
        ls = _lower(solid, c)
        vs[c] = ls * torch.clamp(v, min=repel) + (1.0 - ls) * v
    div = torch.zeros(shape, dtype=vel.dtype, device=dev)
    for c in range(3):
        div = div + _upper(vs[c], c) - vs[c]
    return torch.stack(vs), div


def forces_solids_div_cuda(types, vel, cfg):
    """K6b wrapper: the CUDA kernel for CUDA tensors,
    `forces_solids_div_plain` for CPU tensors."""
    require(vel, "vel", torch.float32)
    if vel.ndim != 4 or vel.shape[0] != 3:
        raise ValueError(f"vel: shape {tuple(vel.shape)}, expected (3,X,Y,Z)")
    shape = tuple(vel.shape[1:])
    require(types, "types", torch.uint8, shape, vel.device)
    if not on_cuda(vel):
        return forces_solids_div_plain(types, vel, cfg)
    out = torch.empty_like(vel)
    div = torch.empty(shape, dtype=vel.dtype, device=vel.device)
    terms = _force_terms(cfg)
    cells = tuple(cell + (c,) for cell, c, _ in terms)
    kterm = tuple(dtf for _, _, dtf in terms)
    cells_ptr = (_device_table(cells, torch.int32, vel.device).data_ptr()
                 if terms else None)
    kterm_ptr = (_device_table(kterm, torch.float32, vel.device).data_ptr()
                 if terms else None)
    with torch.cuda.device(vel.device):
        stream = torch.cuda.current_stream(vel.device).cuda_stream
        build.call("tf_forces_solids_div", _FORCES_ARGTYPES,
                   types.data_ptr(), vel.data_ptr(), out.data_ptr(),
                   div.data_ptr(), *shape, cfg.dt, cfg.gravity,
                   *cfg.fountain, cfg.fountain_force,
                   cfg.solid_repel_velocity, cells_ptr, kterm_ptr,
                   len(terms), stream)
    forces_solids_div_cuda.launches += 1
    return out, div


forces_solids_div_cuda.launches = 0


# --------------------------------------------------------------- stage 13
def _project_scale(cfg) -> float:
    """dt / (rho * dx) in double, as the JAX wrapper forms it."""
    return cfg.dt / (cfg.fluid_density * cfg.cell_width)


def project_plain(types, p, vel, cfg):
    """(types u8, p f32, vel f32 (3,X,Y,Z)) -> vel - scale * (cond *
    (p - p(i - e_c)))."""
    water = types == CellType.WATER
    solid = types == CellType.SOLID
    scale = _f32(_project_scale(cfg))
    comps = []
    for c in range(3):
        cond = (axis_nonzero(types.shape, c, types.device)
                & (water | _lower(water, c, False)) & ~solid
                & ~_lower(solid, c, False)).to(torch.float32)
        grad = p - _lower(p, c)
        comps.append(vel[c] - scale * (cond * grad))
    return torch.stack(comps)


def project_cuda(types, p, vel, cfg):
    """K6c wrapper: the CUDA kernel for CUDA tensors, `project_plain` for
    CPU tensors."""
    require(vel, "vel", torch.float32)
    if vel.ndim != 4 or vel.shape[0] != 3:
        raise ValueError(f"vel: shape {tuple(vel.shape)}, expected (3,X,Y,Z)")
    shape = tuple(vel.shape[1:])
    require(types, "types", torch.uint8, shape, vel.device)
    require(p, "p", torch.float32, shape, vel.device)
    if not on_cuda(vel):
        return project_plain(types, p, vel, cfg)
    out = torch.empty_like(vel)
    with torch.cuda.device(vel.device):
        stream = torch.cuda.current_stream(vel.device).cuda_stream
        build.call("tf_project", _PROJECT_ARGTYPES, types.data_ptr(),
                   p.data_ptr(), vel.data_ptr(), out.data_ptr(), *shape,
                   _project_scale(cfg), stream)
    project_cuda.launches += 1
    return out


project_cuda.launches = 0
