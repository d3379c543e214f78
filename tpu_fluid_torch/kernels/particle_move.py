"""K3+K4: stage-14 particle move, sampling the staggered velocity with the
packed-table weights and taking the Euler step, with the stage-15
occupancy scatter taken in.

Replaces `tpu_fluid/kernels/pack_table.py:build_packed_table_pallas` and
`build_packed_table_pallas2` (the 64-lane and z-paired 128-lane tables),
the XLA row gather of `tpu_fluid/stages/particles.py:move_particles`,
`tpu_fluid/kernels/particle_sample.py:sample_and_move`, and the XLA
scatter of `tpu_fluid/stages/particles.py:detailed_occupancy`; CUDA
source `csrc/particle_move.cu`.  The table exists because the TPU has no
fast element gather; the card has one, so one thread per particle reads
the 8 nonzero taps of each component straight from the velocity field,
accumulates them in the table's lane order, moves the particle and, if it
is active and its detailed cell lies in the detailed grid, stores a 1
there.  It is bound by those 24 scattered reads per particle; no table
(537 MB at 128^3), no row buffer and no index tensor are written.

The local-slab form (`particle_move_local_cuda`) is the same kernel,
without the occupancy, on a shard's (3, lx + 2, Y, Z) velocity slab with
one edge-replicated plane a side, which domain-sharded particles sample
(`tpu_fluid/parallel/particles_domain.py:move_particles_local`): positions
and weights stay global, the row of a particle's cell is its slab-local x
row clipped to the extended slab, and each x tap is clipped within it.
Domain sharding scatters its occupancy after the migration, in plain torch
(`parallel/particles_domain.detailed_occupancy_local`).

`particle_move_plain` keeps the TPU formulation in plain PyTorch: build
the 64-lane table, gather one row per particle, and accumulate the 18 lanes
of each component one by one in the loop order of `_sample_update_kernel`.
`scatter_occupancy` is the stage-15 scatter; `particle_move_occupancy_plain`,
the wrapper's plain version, is the one and then the other.
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.kernels import build, on_cuda, require, store
from tpu_fluid_torch.ops.indexing import float_to_index
from tpu_fluid_torch.ops.packed_sampler import (_OTHER, _lane,
                                                build_packed_table,
                                                cell_index,
                                                packed_row_indices)

_ARGTYPES = ((build.POINTER,) * 5 + (build.INT64,) + (build.INT,) * 5
             + (build.FLOAT, build.INT, build.POINTER))


def sample_and_move_rows(rows: torch.Tensor, pos: torch.Tensor,
                         active: torch.Tensor, dt: float,
                         grid_size) -> torch.Tensor:
    """`sample_and_move` on gathered (P, 64) rows: hat weights clamped to
    the global `grid_size`, the 18 lanes of each component accumulated one
    by one, then the Euler step of the active particles."""
    top = [float(g) - 1.0 for g in grid_size]
    jf = [torch.clamp(torch.floor(pos[:, d]), 0.0, top[d]) for d in range(3)]
    v = []
    for c in range(3):
        os_, fs = [], []
        for d in range(3):
            t = torch.clamp(pos[:, d] - 0.5 + (0.5 if d == c else 0.0),
                            0.0, top[d])
            i0 = torch.floor(t)
            os_.append(i0 - jf[d])
            fs.append(t - i0)
        a1, a2 = _OTHER[c]

        def axw(d, delta):
            # selects, as XLA makes of the TPU kernel's mask products: a
            # NaN coordinate weighs 0 on its axis, so it moves no other
            return (torch.where(os_[d] == delta, 1.0 - fs[d], 0.0)
                    + torch.where(os_[d] == delta - 1, fs[d], 0.0))

        acc = torch.zeros_like(pos[:, 0])
        for dc in (0, 1):
            wc = (1.0 - fs[c]) if dc == 0 else fs[c]
            for d1 in (-1, 0, 1):
                w1 = axw(a1, d1)
                for d2 in (-1, 0, 1):
                    lane = rows[:, _lane(c, dc, d1, d2)]
                    acc = acc + (wc * w1 * axw(a2, d2)) * lane
        v.append(acc)
    return torch.stack([pos[:, d] + torch.where(active, v[d] * dt, 0.0)
                        for d in range(3)], dim=1)


def particle_move_plain(vel: torch.Tensor, pos: torch.Tensor,
                        active: torch.Tensor, dt: float) -> torch.Tensor:
    grid = tuple(vel.shape[1:])
    table = build_packed_table(vel)
    rows = table.index_select(0, packed_row_indices(pos, grid))
    return sample_and_move_rows(rows, pos, active, dt, grid)


def scatter_occupancy(positions: torch.Tensor, active: torch.Tensor,
                      res: int, detailed_size) -> torch.Tensor:
    """Occupancy (0/1 uint8) of the detailed grid of `detailed_size`, `res`
    detailed cells a sim cell along each axis.  The pipeline only ever
    consumes density > 0 (stage 02's water test, stage 16's filled and
    neighbour tests), so one scatter of the constant 1 serves both of the
    reference's histograms.  Indices truncate toward zero and convert as
    XLA converts (`ops/indexing.float_to_index`: a NaN to 0); inactive and
    out-of-grid particles are routed to a dropped slot (never clamped), and
    duplicates all write 1, so the scatter is deterministic."""
    dx, dy, dz = detailed_size
    idx = float_to_index(torch.trunc(positions * float(res)))
    x, y, z = idx[:, 0], idx[:, 1], idx[:, 2]
    inb = ((x >= 0) & (x < dx) & (y >= 0) & (y < dy) & (z >= 0) & (z < dz)
           & active)
    n = dx * dy * dz
    flat = torch.where(inb, x * (dy * dz) + y * dz + z, n)
    occ = torch.zeros(n + 1, dtype=torch.uint8, device=positions.device)
    occ.index_fill_(0, flat, 1)   # no host scalar: capturable
    return occ[:n].reshape(dx, dy, dz)


def particle_move_occupancy_plain(vel: torch.Tensor, pos: torch.Tensor,
                                  active: torch.Tensor, dt: float,
                                  res: int, *, out=None) -> tuple:
    """Stages 14 and 15 in plain PyTorch: the moved positions, and the
    occupancy of the moved active ones on the detailed grid `res` times
    the sim grid; copied into `out`'s (positions, occupancy) where
    given."""
    moved = particle_move_plain(vel, pos, active, dt)
    dsize = tuple(res * n for n in vel.shape[1:])
    return store((moved, scatter_occupancy(moved, active, res, dsize)), out)


def particle_move_local_plain(vel_e: torch.Tensor, pos: torch.Tensor,
                              active: torch.Tensor, dt: float, x0: int,
                              grid_size, *, out=None) -> torch.Tensor:
    """The TPU formulation on a local slab: the 64-lane table of the
    extended slab `vel_e` (3, lx + 2, Y, Z) whose row 1 is global x0, one
    row per particle (its global cell, clipped to the grid, then its x row
    clipped to the extended slab, `particles_domain.py:139-142`), and the
    lane sums with global weights; copied into `out` where given."""
    lx = vel_e.shape[1] - 2
    _, gy, gz = grid_size
    j = cell_index(pos, grid_size)
    jx = torch.clamp(j[:, 0] - x0 + 1, 0, lx + 1)
    rows = build_packed_table(vel_e).index_select(
        0, jx * (gy * gz) + j[:, 1] * gz + j[:, 2])
    return store(sample_and_move_rows(rows, pos, active, dt,
                                      tuple(grid_size)), out)


def _check(vel: torch.Tensor, pos: torch.Tensor,
           active: torch.Tensor) -> None:
    require(vel, "vel", torch.float32)
    if vel.ndim != 4 or vel.shape[0] != 3:
        raise ValueError(f"vel: shape {tuple(vel.shape)}, expected (3,X,Y,Z)")
    require(pos, "pos", torch.float32, device=vel.device)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"pos: shape {tuple(pos.shape)}, expected (P,3)")
    require(active, "active", torch.bool, (pos.shape[0],), vel.device)


def _launch(vel, pos, active, dt, xb, grid_size, occ=None, res=0,
            out=None) -> torch.Tensor:
    """The kernel on memory rows [xb, xb + vel.shape[1]) of a grid of
    global extent `grid_size`, scattering into `occ` where it is given,
    moving into `out` (else a new tensor)."""
    out = torch.empty_like(pos) if out is None else out
    gx, gy, gz = grid_size
    with torch.cuda.device(vel.device):
        stream = torch.cuda.current_stream(vel.device).cuda_stream
        build.call("tf_particle_move", _ARGTYPES, vel.data_ptr(),
                   pos.data_ptr(), active.data_ptr(), out.data_ptr(),
                   None if occ is None else occ.data_ptr(), pos.shape[0],
                   xb, vel.shape[1], gx, gy, gz, dt, res, stream)
    return out


def particle_move_cuda(vel: torch.Tensor, pos: torch.Tensor,
                       active: torch.Tensor, dt: float, res: int, *,
                       out=None) -> tuple:
    """K3+K4 wrapper: vel (3,X,Y,Z) f32, pos (P,3) f32, active (P,) bool
    and the detailed cells a sim cell `res` -> (the moved positions (P,3),
    the (res X, res Y, res Z) u8 occupancy of the moved active ones),
    written into `out`'s (positions, occupancy) tensors where given; the
    CUDA kernel for CUDA tensors, `particle_move_occupancy_plain` for CPU
    tensors."""
    _check(vel, pos, active)
    if not isinstance(res, int) or res < 1:
        raise ValueError(f"res = {res!r}, expected an int >= 1")
    grid = tuple(vel.shape[1:])
    dsize = tuple(res * n for n in grid)
    moved, occ = (None, None) if out is None else out
    if moved is not None:
        require(moved, "out positions", torch.float32, pos.shape, vel.device)
    if occ is not None:
        require(occ, "out occupancy", torch.uint8, dsize, vel.device)
    if not on_cuda(vel):
        return particle_move_occupancy_plain(vel, pos, active, dt, res,
                                             out=out)
    if occ is None:
        occ = torch.zeros(dsize, dtype=torch.uint8, device=vel.device)
    else:
        occ.zero_()
    moved = _launch(vel, pos, active, dt, 0, grid, occ, res, moved)
    particle_move_cuda.launches += 1
    return moved, occ


def particle_move_local_cuda(vel_e: torch.Tensor, pos: torch.Tensor,
                             active: torch.Tensor, dt: float, x0: int,
                             grid_size, *, out=None) -> torch.Tensor:
    """K3+K4's local-slab form: vel_e (3, lx+2, Y, Z) f32, the shard's slab
    with one edge-replicated plane a side, whose row 1 is global x0;
    global positions pos (P,3) f32 and active (P,) bool -> moved positions
    (P,3), no occupancy, written into `out` where given.  The CUDA kernel
    for CUDA tensors, `particle_move_local_plain` for CPU tensors."""
    _check(vel_e, pos, active)
    gx, gy, gz = grid_size
    lx = vel_e.shape[1] - 2
    if tuple(vel_e.shape[2:]) != (gy, gz) or lx < 1 or not (
            0 <= x0 and x0 + lx <= gx):
        raise ValueError(f"vel_e: shape {tuple(vel_e.shape)} is no extended "
                         f"slab at x0={x0} of grid {tuple(grid_size)}")
    if out is not None:
        require(out, "out positions", torch.float32, pos.shape, vel_e.device)
    if not on_cuda(vel_e):
        return particle_move_local_plain(vel_e, pos, active, dt, x0,
                                         grid_size, out=out)
    out = _launch(vel_e, pos, active, dt, x0 - 1, tuple(grid_size),
                  out=out)
    particle_move_local_cuda.launches += 1
    return out


particle_move_cuda.launches = 0
particle_move_local_cuda.launches = 0
