"""The initial state a run starts from, made from `--seed` on the device.

Every particle of the configuration's cubes starts at its lattice point of
the cube, `offset + index / resolution * size`, moved by a uniform offset
drawn from the seed inside its own lattice spacing; ids past the cubes stay
inactive at the origin.  The velocity, the pressure-free grid fields and
the counters start at zero, the cell types INACTIVE, and the detailed
occupancy is that of the initial positions.  The same state is handed to
the program and to the reference.

The slab seed (`x_range`) builds only some x-planes of the grid fields,
and of the detailed grid the planes `r * x0 ... r * x1` (r the detail
resolution), with the occupancy of the particles inside them: bitwise the
same planes of the whole state, which a rank of a multi-card cell need
not build.  The particles, their flags and the counters stay whole.

The seed reads sizes, never options: it seeds every configuration the
program takes (domain-sharded particles, volume correction, the level set,
the red-black solver, solid boxes), and the reference a configuration
names (`check.py`) decides what can be judged.  `run.run_cell` asks that
reference first, so a configuration it refuses ends before any set-up.
"""

from __future__ import annotations

import torch

from fluid_bench.reference.step import INACTIVE, float_to_index, occupancy


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 63)
    return g


def particles(fields: dict, seed: int, device):
    """(positions (P, 3) f32, active (P,) bool)."""
    p = fields["particle_count"]
    cubes = [(fields["particle_init_cube_resolution"],
              fields["particle_init_cube_offset"],
              fields["particle_init_cube_size"])]
    cubes += [tuple(c) for c in fields["extra_particle_cubes"]]
    jitter = torch.rand((p, 3), generator=generator(seed, device),
                        device=device, dtype=torch.float32)
    ids = torch.arange(p, dtype=torch.int64, device=device)
    pos = torch.zeros((p, 3), dtype=torch.float32, device=device)
    active = torch.zeros((p,), dtype=torch.bool, device=device)
    start = 0
    for (rx, ry, rz), offset, size in cubes:
        rel = ids - start
        idx = torch.stack([rel % rx, (rel // rx) % ry, (rel // (rx * ry)) % rz],
                          dim=-1).to(torch.float32)
        res = torch.tensor([rx, ry, rz], dtype=torch.float32, device=device)
        off = torch.tensor(offset, dtype=torch.float32, device=device)
        size = torch.tensor(size, dtype=torch.float32, device=device)
        inside = (ids >= start) & (ids < start + rx * ry * rz)
        pos = torch.where(inside[:, None], off + (idx + jitter) / res * size,
                          pos)
        active = active | inside
        start += rx * ry * rz
    return pos, active


def detailed_size(fields: dict) -> tuple:
    """The detailed grid's size: the grid's times the detail resolution."""
    r = fields["surface_render_resolution"]
    return tuple(s * r for s in fields["grid_size"])


def inertia_dtype(fields: dict) -> torch.dtype:
    """uint8 where every inertia value fits it, else int32."""
    return torch.uint8 if 0 < fields["max_inertia"] <= 255 else torch.int32


def slab(fields: dict, rank: int, size: int) -> tuple:
    """The grid x-planes (x0, x1) of shard `rank` of `size`."""
    lx = fields["grid_size"][0] // size
    return rank * lx, (rank + 1) * lx


def slab_occupancy(positions, active, res, detailed_size, dx0):
    """`occupancy` of the whole detailed grid, planes dx0 ... dx0 +
    detailed_size[0] only: the same truncated index, its x taken from
    dx0."""
    dx, dy, dz = detailed_size
    idx = float_to_index(torch.trunc(positions * float(res)))
    x, y, z = idx[:, 0] - dx0, idx[:, 1], idx[:, 2]
    inb = ((x >= 0) & (x < dx) & (y >= 0) & (y < dy) & (z >= 0) & (z < dz)
           & active)
    n = dx * dy * dz
    flat = torch.where(inb, x * (dy * dz) + y * dz + z, n)
    occ = torch.zeros(n + 1, dtype=torch.uint8, device=positions.device)
    occ.index_fill_(0, flat, 1)
    return occ[:n].reshape(dx, dy, dz)


def initial(fields: dict, seed: int, device, x_range=None) -> dict:
    """The whole initial state, field name -> tensor on `device`; with
    `x_range` = (x0, x1) the grid fields' x-planes x0 ... x1 only."""
    gx, gy, gz = fields["grid_size"]
    dsize = detailed_size(fields)
    pos, active = particles(fields, seed, device)
    res = fields["surface_render_resolution"]
    if x_range is None:
        occ = occupancy(pos, active, res, dsize)
    else:
        x0, x1 = x_range
        if not 0 <= x0 < x1 <= gx:
            raise ValueError(f"x_range {x_range} outside the grid's {gx}")
        gx = x1 - x0
        dsize = (res * gx,) + tuple(dsize[1:])
        occ = slab_occupancy(pos, active, res, dsize, res * x0)
    return {
        "velocity": torch.zeros((3, gx, gy, gz), dtype=torch.float32,
                                device=device),
        "cell_types": torch.full((gx, gy, gz), INACTIVE, dtype=torch.uint8,
                                 device=device),
        "inertia": torch.zeros(dsize, dtype=inertia_dtype(fields),
                               device=device),
        "float_dens_1": torch.zeros(dsize, dtype=torch.float32,
                                    device=device),
        "float_dens_2": torch.zeros(dsize, dtype=torch.float32,
                                    device=device),
        "positions": pos,
        "active": active,
        "detailed_occ": occ,
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "dropped": torch.zeros((), dtype=torch.int32, device=device),
    }
