"""The plain reference of one step of the x-slab layout with domain-sharded
particles (`particle_sharding="domain"`): the 19 stages of
`reference/step.py` on one rank's x-slab, in plain PyTorch, with the halo
planes each stage reads exchanged over the rank's process group with plain
`torch.distributed` sends and receives.

It is called on every rank of a multi-card cell (`SHARDED`), each with its
own part of a sample: the grid fields' x-slab (rank r of n holds the grid
rows [r lx, (r + 1) lx), lx = X / n, and the detailed rows r times the
detail resolution), and `slots` particle rows holding the particles whose
cell x lies in the slab.  `part` cuts a seeded state so: a census of the
whole set, the fullest slab's count times `particle_slot_slack` rounded up
to 128 rows on every rank, the rank's particles first, in index order.

Every grid stage computes what `reference/step.py` computes on the whole
grid, operation for operation and in the same order, on the slab extended
by the neighbours' planes it reads (zeros past the domain ends, the
whole-grid step's fill; the velocity edge-replicated there where the
whole-grid step clamps), with global coordinates wherever the whole-grid
step uses positions (the border and box SOLID rule, the fountain and force
cells, the i_x != 0 tests, the advection's clamp).  So the slabs put
together are `reference/step.py`'s grid fields bitwise.  Where it departs
from `reference/step.py`:

  - the solve exchanges `SWEEPS` planes of the pressure and runs that many
    sweeps on the extended slab before the next exchange, as the
    program's sharded passes do, with the rows past the domain ends put
    back to 0 after each sweep;
  - the particles are moved on the rank's velocity slab with one
    edge-replicated plane a side: a particle's cell is clipped to the
    grid, then its x row to that slab, each tap by the table's edge rule
    within it.  A particle inside the slab reads what the whole-grid step
    reads; one more than a plane outside it reads the clipped row, as the
    program's local move does;
  - each lane is gathered from the velocity for its particles (the taps
    of the whole-grid step's 64-lane table, never built), and particles,
    detailed rows and advected rows are taken a block at a time, so the
    memory stays within what the judge leaves free beside the samples of
    a 768^3 slab;
  - after the move, the active particles whose cell x left the slab go to
    the neighbour on that side, at most `migrate capacity` a direction
    (`particle_migrate_frac` of the slots, at least 128, a multiple of
    128), in slot order.  The holes are the leavers in slot order, left
    then right, then the inactive slots; the arrivals from the left, then
    from the right, each in the order sent, take the holes in turn while
    both last.  A leaver that finds no place, or leaves the domain, is
    dropped: deactivated where it was and counted into `dropped`, summed
    over the ranks.  A single rank moves nothing;
  - the detailed occupancy is scattered from the rank's particles after
    the migration, onto its detailed slab.

Options are those of `reference/step.py`'s `SUPPORTED`, with domain-
sharded particles; any other raises, naming it (`Scene`).  A scene's
solid and force fields are no configuration key: `step` takes none.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fluid_bench.reference import step as ref
from fluid_bench.reference.step import (AIR, AXIS_MOVES, FIELDS,  # noqa
                                        FLOAT_FIELDS, INACTIVE, MOVES,
                                        SOLID, WATER, _OTHER, div_scalar,
                                        float_to_index, neighbor_sum, pool,
                                        shifted)

SHARDED = True
# the options this reference implements, and the value each must have
SUPPORTED = dict(ref.SUPPORTED, particle_sharding="domain")
# sweeps of the solve between two exchanges (the program's `SHARDED_K`)
SWEEPS = 8
# elements of a block: the detailed grid's blur and inertia, the
# advection's rows, the particles' lanes (each a few float32 temporaries)
BLOCK = 1 << 25


class Scene(ref.Scene):
    """The configuration's numbers, read from its file's `fields`."""

    def __init__(self, fields: dict):
        for key, want in SUPPORTED.items():
            if fields.get(key, want) != want:
                raise ValueError(f"reference: {key}={fields[key]!r} is not "
                                 f"implemented (only {want!r})")
        if fields.get("advect_method", "auto") not in ("auto", "pallas",
                                                       "shift"):
            raise ValueError("reference: only the shift advection")
        self.f = dict(fields)


# --------------------------------------------------------- the exchange
def _where(group) -> tuple:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _peer(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """`t` as the process group sends it: bools and 16-bit floats as their
    bytes (gloo sends neither; nccl sends no 16-bit integer)."""
    t = t.contiguous()
    if t.dtype in (torch.bool, torch.bfloat16, torch.float16):
        return t.view(torch.uint8)
    return t


def swap(to_left, to_right, from_left_shape, from_right_shape, group):
    """Send `to_left` to the rank on the left and `to_right` to the one on
    the right, and receive what they sent this way, of the shapes given:
    (from_left, from_right), zeros (of `to_right`'s and `to_left`'s
    dtype) where there is no neighbour."""
    r, n = _where(group)
    from_left = torch.zeros(from_left_shape, dtype=to_right.dtype,
                            device=to_right.device)
    from_right = torch.zeros(from_right_shape, dtype=to_left.dtype,
                             device=to_left.device)
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, _wire(to_left), _peer(group, r - 1),
                           group),
                dist.P2POp(dist.irecv, _wire(from_left), _peer(group, r - 1),
                           group)]
    if r < n - 1:
        ops += [dist.P2POp(dist.isend, _wire(to_right), _peer(group, r + 1),
                           group),
                dist.P2POp(dist.irecv, _wire(from_right),
                           _peer(group, r + 1), group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_left, from_right


def planes(a, h: int, group) -> tuple:
    """The h planes of the neighbours next to this slab, along x (dim
    ndim - 3): (left, right), zeros past the domain ends."""
    ax = a.ndim - 3
    n = a.shape[ax]
    if not 0 < h <= n:
        raise ValueError(f"{h} halo planes from a slab of {n} rows")
    left, right = a.narrow(ax, 0, h), a.narrow(ax, n - h, h)
    return swap(left, right, right.shape, left.shape, group)


def extend(a, h: int, group):
    """The slab with h neighbour planes a side (zeros past the domain
    ends)."""
    left, right = planes(a, h, group)
    return torch.cat([left, a, right], dim=a.ndim - 3)


def edge_extend(a, h: int, group):
    """The slab with h neighbour planes a side, and past a domain end its
    own edge plane h times: the whole grid's edge clamp."""
    r, n = _where(group)
    ax = a.ndim - 3
    left, right = planes(a, h, group)
    if r == 0:
        left = a.narrow(ax, 0, 1).repeat_interleave(h, dim=ax)
    if r == n - 1:
        right = a.narrow(ax, a.shape[ax] - 1, 1).repeat_interleave(h, dim=ax)
    return torch.cat([left, a, right], dim=ax)


def inner(a, h: int = 1):
    ax = a.ndim - 3
    return a.narrow(ax, h, a.shape[ax] - 2 * h)


def _rows(total: int, per_row: int) -> list:
    """[a, b) blocks of `total` rows of `per_row` elements, each about
    `BLOCK` elements."""
    step = max(1, BLOCK // max(1, per_row))
    return [(a, min(a + step, total)) for a in range(0, total, step)]


# ------------------------------------------------ global coordinates
def _x_nonzero(x0: int, lx: int, device):
    """i_x != 0 of the slab's rows, by their global row."""
    return (torch.arange(x0, x0 + lx, device=device) != 0).reshape(-1, 1, 1)


def solid_mask(shape, cfg, x0: int, device):
    gx = cfg.grid_size[0]
    lx, gy, gz = shape
    ix = torch.arange(x0, x0 + lx, device=device)[:, None, None]
    iy = torch.arange(gy, device=device)[None, :, None]
    iz = torch.arange(gz, device=device)[None, None, :]
    mask = ((ix == 0) | (ix == gx - 1) | (iy == 0) | (iy == gy - 1)
            | (iz == 0) | (iz == gz - 1))
    for (bx0, by0, bz0), (bx1, by1, bz1) in cfg.solid_boxes:
        mask = mask | ((ix >= bx0) & (ix < bx1) & (iy >= by0) & (iy < by1)
                       & (iz >= bz0) & (iz < bz1))
    return mask


def _cell(shape, cell, x0: int, device):
    """A mask of the global cell `cell`, empty where it is not in the
    slab."""
    at = torch.zeros(shape, dtype=torch.bool, device=device)
    if x0 <= cell[0] < x0 + shape[0]:
        at[(cell[0] - x0,) + tuple(cell[1:])] = True
    return at


# ---------------------------------------------------- stages 01-06
def classify(occ_sim, cfg, x0: int, group):
    """Stages 02-03 (`step.classify`) on the slab."""
    types = torch.where(occ_sim > 0, WATER, INACTIVE).to(torch.uint8)
    solid = solid_mask(types.shape, cfg, x0, types.device)
    water = types == WATER
    water_e = extend(water, 1, group)
    around = torch.zeros_like(water_e)
    for mv in MOVES:
        around = around | shifted(water_e, mv, fill=False)
    air = (~water) & inner(around)
    wet = torch.where(air, torch.full_like(types, AIR), types)
    return torch.where(solid, torch.full_like(types, SOLID), wet)


def extrapolate(old_types, new_types, vel, group):
    """Stages 04-05 (`step.extrapolate`) on the slab."""
    return inner(ref.extrapolate(extend(old_types, 1, group),
                                 extend(new_types, 1, group),
                                 extend(vel, 1, group)))


# ----------------------------------------------------- stage 07
def advect(types, vel, cfg, x0: int, group):
    """Stage 07 (`step.advect`) on the slab, a block of rows at a time:
    the velocity with R edge-replicated planes a side stands for the whole
    grid's edge-padded one, and the x weights take the global row."""
    r = cfg.advect_max_displacement
    dt = cfg.dt
    gx = cfg.grid_size[0]
    lx, gy, gz = types.shape
    dev = vel.device
    water_e = extend(types == WATER, 1, group)
    vx = edge_extend(vel, r, group)
    x_all = torch.arange(gx, dtype=vx.dtype, device=dev)
    out = torch.empty_like(vel)
    for a, b in _rows(lx, gy * gz):
        n = b - a
        block = vx[:, a:b + 2 * r]
        for c in range(3):
            up = tuple(1 if k == c else 0 for k in range(3))
            cond = inner(water_e[a:b + 2] | shifted(water_e[a:b + 2], up,
                                                    fill=False))
            if c == 0:
                cond = cond & _x_nonzero(x0 + a, n, dev)
            else:
                cond = cond & ref.axis_nonzero((n, gy, gz), c, dev)
            u = -ref._face_center_velocity(block, c)[:, r:r + n] * dt
            u = torch.clamp(u, -r, r - 1e-4)
            axes = []
            for d, size in enumerate((gx, gy, gz)):
                if d == 0:
                    i_d = x_all[x0 + a:x0 + b].reshape(-1, 1, 1)
                else:
                    i_d = torch.arange(size, dtype=vx.dtype,
                                       device=dev).reshape(
                        tuple(-1 if k == d else 1 for k in range(3)))
                t_d = torch.clamp(i_d + u[d], 0.0, size - 1.0)
                u_d = t_d - i_d
                o_d = torch.floor(u_d)
                f_d = u_d - o_d
                axes.append([torch.where(o_d == delta, 1.0 - f_d, 0.0)
                             + torch.where(o_d == delta - 1, f_d, 0.0)
                             for delta in range(-r, r + 1)])
            del u
            wx, wy, wz = axes
            padded = block[c]
            for ax in (1, 2):
                m = padded.shape[ax]
                pidx = torch.clamp(torch.arange(-r, m + r, device=dev), 0,
                                   m - 1)
                padded = padded.index_select(ax, pidx)
            acc = torch.zeros((n, gy, gz), dtype=vx.dtype, device=dev)
            for ax, dxo in enumerate(range(-r, r + 1)):
                for ay, dyo in enumerate(range(-r, r + 1)):
                    wxy = wx[ax] * wy[ay]
                    for az, dzo in enumerate(range(-r, r + 1)):
                        sl = padded[r + dxo:r + dxo + n,
                                    r + dyo:r + dyo + gy,
                                    r + dzo:r + dzo + gz]
                        acc = acc + (wxy * wz[az]) * sl
            out[c, a:b] = torch.where(cond, acc, block[c, r:r + n])
            del axes, wx, wy, wz, padded, acc
    return out


# ----------------------------------------------------- stages 08-11
def apply_forces(types, vel, cfg, x0: int, group):
    """Stage 08 (`step.apply_forces`) on the slab: the fountain and the
    force cells are global cells."""
    water = types == WATER
    wet_face = water | shifted(water, (0, -1, 0), fill=False)
    ynz = ref.axis_nonzero(types.shape, 1, types.device)
    force = torch.where(wet_face & ynz, cfg.gravity, 0.0).to(vel.dtype)
    fountain = _cell(types.shape, cfg.fountain, x0, vel.device)
    force = force + torch.where(fountain & wet_face, cfg.fountain_force,
                                0.0).to(vel.dtype)
    out = vel.clone()
    out[1] = vel[1] + cfg.dt * force
    if cfg.extra_forces:
        water_e = extend(water, 1, group)
    for cell, fvec in cfg.extra_forces:
        at = _cell(types.shape, cell, x0, vel.device)
        for c in range(3):
            if fvec[c] == 0.0:
                continue
            mv = tuple(-1 if k == c else 0 for k in range(3))
            wet_c = water | inner(shifted(water_e, mv, fill=False))
            out[c] = out[c] + torch.where(at & wet_c, cfg.dt * fvec[c],
                                          0.0).to(vel.dtype)
    return out


def diffuse(types, vel, cfg, group):
    """Stage 09 (`step.diffuse`) on the slab."""
    if cfg.reference_diffuse_noop:
        return vel
    return inner(ref.diffuse(extend(types, 1, group), extend(vel, 1, group),
                             cfg))


def apply_solids(types, vel, cfg, group):
    """Stage 10 (`step.apply_solids`) on the slab."""
    return inner(ref.apply_solids(extend(types, 1, group),
                                  extend(vel, 1, group), cfg))


def divergence(vel, group):
    """Stage 11 (`step.divergence`) on the slab."""
    return inner(ref.divergence(extend(vel, 1, group)))


# ----------------------------------------------------- stages 12-13
def jacobi(types, div, cfg, dtype, group):
    """Stage 12 (`step.jacobi`) on the slab: the fold from the types with
    one neighbour plane, then passes of `SWEEPS` sweeps, each on the
    pressure extended by that many of the neighbours' planes; the rows
    past the domain ends are put back to 0 after each sweep."""
    r, n = _where(group)
    boundary = cfg.air_pressure
    b = div.to(dtype) * (cfg.fluid_density * cfg.cell_width / cfg.dt)
    iters = cfg.jacobi_iters - (1 if cfg.reference_pressure_parity else 0)
    types_e = extend(types, 1, group)
    water_e = types_e == WATER
    solid_e = types_e == SOLID
    aii = torch.zeros(types_e.shape, dtype=dtype, device=types.device)
    n_air = torch.zeros_like(aii)
    for mv in MOVES:
        nb_solid = shifted(solid_e, mv, fill=False)
        nb_water = shifted(water_e, mv, fill=False)
        aii = aii + (~nb_solid)
        n_air = n_air + (~nb_solid & ~nb_water)
    aii, n_air = inner(aii), inner(n_air)
    del types_e, water_e, solid_e
    water = types == WATER
    const = n_air * boundary - b.to(dtype)
    code = torch.where(water & (aii > 0), aii, 0.0).to(torch.uint8)
    q0 = torch.where(water, boundary, 0.0).to(dtype)
    c2 = const / torch.clamp(aii, min=1.0)
    codef = code.to(torch.int32).to(dtype)
    rd = torch.where(codef > 0,
                     torch.ones_like(codef) / torch.clamp(codef, min=1.0),
                     0.0)
    c2e = torch.where(code > 0, c2, q0)
    del const, c2, codef, aii, n_air, b
    lx = types.shape[0]
    h = min(SWEEPS, lx)
    rd_e, c2e_e = extend(rd, h, group), extend(c2e, h, group)
    del rd, c2e
    q = q0
    for done in range(0, iters, h):
        q_e = extend(q, h, group)
        for _ in range(min(h, iters - done)):
            q_e = rd_e * neighbor_sum(q_e, moves=AXIS_MOVES) + c2e_e
            if r == 0:
                q_e[:h] = 0.0
            if r == n - 1:
                q_e[h + lx:] = 0.0
        q = q_e[h:h + lx]
    return torch.where(water, q, boundary)


def project(types, p, vel, cfg, x0: int, group):
    """Stage 13 (`step.project`) on the slab: the x gradient reads the
    plane on the left; i_x != 0 is the global row's."""
    lx = types.shape[0]
    types_e = extend(types, 1, group)
    p_e = extend(p, 1, group)
    water_e = types_e == WATER
    solid_e = types_e == SOLID
    water, solid = inner(water_e), inner(solid_e)
    scale = cfg.dt / (cfg.fluid_density * cfg.cell_width)
    out = []
    for c in range(3):
        mv = tuple(-1 if k == c else 0 for k in range(3))
        nz = (_x_nonzero(x0, lx, types.device) if c == 0
              else ref.axis_nonzero(types.shape, c, types.device))
        cond = (nz & (water | inner(shifted(water_e, mv, fill=False)))
                & ~solid & ~inner(shifted(solid_e, mv, fill=False)))
        grad = p - inner(shifted(p_e, mv))
        dv = torch.where(cond, grad, 0.0).to(vel.dtype)
        out.append(vel[c] - scale * dv)
    return torch.stack(out)


# ----------------------------------------------------- stage 14
def move_particles(vel, pos, active, cfg, x0: int, group):
    """Stage 14 (`step.move_particles`) on the slab with one
    edge-replicated plane a side, a block of particles at a time: each
    lane is read from the velocity at the particle's cell plus the lane's
    offset, clipped as the whole grid's table clips (the x row to the
    extended slab), and summed in the table's lane order."""
    gx, gy, gz = cfg.grid_size
    lx = vel.shape[1]
    vel_e = edge_extend(vel, 1, group)
    flat = vel_e.reshape(3, -1)
    ext = (lx + 2, gy, gz)
    grid = (gx, gy, gz)
    top = [float(g) - 1.0 for g in grid]
    out = torch.empty_like(pos)
    for a, b in _rows(pos.shape[0], 8):
        p = pos[a:b]
        j = float_to_index(torch.floor(p))
        j = [torch.clamp(j[:, d], 0, grid[d] - 1) for d in range(3)]
        j[0] = torch.clamp(j[0] - x0 + 1, 0, lx + 1)
        jf = [torch.clamp(torch.floor(p[:, d]), 0.0, top[d])
              for d in range(3)]

        def lane(c, off):
            at = [torch.clamp(j[d] + off[d], 0, ext[d] - 1) for d in range(3)]
            return flat[c].index_select(0, (at[0] * gy + at[1]) * gz + at[2])

        v = []
        for c in range(3):
            os_, fs = [], []
            for d in range(3):
                t = torch.clamp(p[:, d] - 0.5 + (0.5 if d == c else 0.0),
                                0.0, top[d])
                i0 = torch.floor(t)
                os_.append(i0 - jf[d])
                fs.append(t - i0)
            a1, a2 = _OTHER[c]

            def axw(d, delta):
                return (torch.where(os_[d] == delta, 1.0 - fs[d], 0.0)
                        + torch.where(os_[d] == delta - 1, fs[d], 0.0))

            acc = torch.zeros_like(p[:, 0])
            for dc in (0, 1):
                wc = (1.0 - fs[c]) if dc == 0 else fs[c]
                for d1 in (-1, 0, 1):
                    w1 = axw(a1, d1)
                    for d2 in (-1, 0, 1):
                        off = [0, 0, 0]
                        off[c] = dc
                        off[a1] = d1
                        off[a2] = d2
                        acc = acc + (wc * w1 * axw(a2, d2)) * lane(c, off)
            v.append(acc)
        out[a:b] = torch.stack([p[:, d] + torch.where(active[a:b],
                                                      v[d] * cfg.dt, 0.0)
                                for d in range(3)], dim=1)
    return out


# ----------------------------------------------------- the migration
def migrate_capacity(slots: int, cfg) -> int:
    """Rows a direction a rank may send a step."""
    return max(128, -(-int(slots * cfg.particle_migrate_frac) // 128) * 128)


def migrate(pos, active, x0: int, lx: int, m: int, group) -> tuple:
    """(positions, active, this rank's drops) after the leavers went to
    their neighbours and the arrivals took the holes (module
    docstring)."""
    r, n = _where(group)
    if n == 1:
        return pos, active, 0
    cx = float_to_index(torch.floor(pos[:, 0]))
    go_l = active & (cx < x0)
    go_r = active & (cx >= x0 + lx)
    keep = active & ~go_l & ~go_r
    left = torch.nonzero(go_l).squeeze(1)
    right = torch.nonzero(go_r).squeeze(1)
    n_l = min(len(left), m) if r > 0 else 0
    n_r = min(len(right), m) if r < n - 1 else 0
    counts = torch.tensor([n_l, n_r], dtype=torch.int64, device=pos.device)
    c_left, c_right = swap(counts[:1], counts[1:], (1,), (1,), group)
    c_left, c_right = int(c_left[0]), int(c_right[0])
    # the rows sent, at least one a direction (no empty message)
    in_l, in_r = swap(pos[left[:max(n_l, 1)]] if n_l else pos[:1],
                      pos[right[:max(n_r, 1)]] if n_r else pos[:1],
                      (max(c_left, 1), 3), (max(c_right, 1), 3), group)
    arrivals = torch.cat([in_l[:c_left], in_r[:c_right]])
    holes = torch.cat([left, right, torch.nonzero(~active).squeeze(1)])
    placed = min(len(arrivals), len(holes))
    new_pos = pos.clone()
    new_pos[holes[:placed]] = arrivals[:placed]
    new_act = keep.clone()
    new_act[holes[:placed]] = True
    return new_pos, new_act, len(left) + len(right) - placed


def occupancy(pos, active, cfg, x0: int, lx: int):
    """Stage 15 (`step.occupancy`) onto the slab's detailed rows, from the
    rank's particles."""
    res = cfg.surface_render_resolution
    dx, dy, dz = lx * res, cfg.detailed_size[1], cfg.detailed_size[2]
    n = dx * dy * dz
    occ = torch.zeros(n + 1, dtype=torch.uint8, device=pos.device)
    for a, b in _rows(pos.shape[0], 8):
        idx = float_to_index(torch.trunc(pos[a:b] * float(res)))
        x, y, z = idx[:, 0] - x0 * res, idx[:, 1], idx[:, 2]
        inb = ((x >= 0) & (x < dx) & (y >= 0) & (y < dy) & (z >= 0)
               & (z < dz) & active[a:b])
        occ.index_fill_(0, torch.where(inb, (x * dy + y) * dz + z, n), 1)
    return occ[:n].reshape(dx, dy, dz)


# ----------------------------------------------------- stages 16-18
def surface_fields(types, occ, inertia, f2, cfg, dtype, group):
    """Stages 16-18 (`step.surface_fields`) on the detailed slab, a block
    of rows at a time; each blur pass exchanges one plane of the buffer
    it reads."""
    r = cfg.surface_render_resolution
    skip = types == SOLID
    for ax in range(3):
        skip = torch.repeat_interleave(skip, r, dim=ax)
    rows, dy, dz = occ.shape
    blocks = _rows(rows, dy * dz)
    occ_e = extend(occ, 1, group)
    new = torch.empty_like(inertia)
    a_f = torch.empty(occ.shape, dtype=dtype, device=occ.device)
    for a, b in blocks:
        filled_e = torch.clamp(occ_e[a:b + 2].to(torch.int32), max=1)
        hits = inner(neighbor_sum(filled_e, moves=AXIS_MOVES))
        filled = inner(filled_e)
        del filled_e
        ge = torch.clamp(hits - (cfg.inertia_required_neighbour_hits - 1),
                         0, 1)
        inc = (filled * cfg.inertia_increase_filled
               + ge * hits * cfg.inertia_increase_neighbour)
        nz = torch.clamp(inc, 0, 1)
        old = inertia[a:b].to(torch.int32)
        increased = old + inc
        decreased = torch.clamp(old - cfg.inertia_decrease, min=0)
        upd = torch.clamp(decreased + nz * (increased - decreased),
                          max=cfg.max_inertia)
        nzi = torch.clamp(upd, 0, 1).to(dtype)
        a_f[a:b] = nzi * div_scalar(
            upd.to(dtype), cfg.float_density_division_coefficient) + (
            nzi - 1.0)
        new[a:b] = upd.to(inertia.dtype)
    del occ_e
    b_f = f2.clone()
    k = cfg.float_density_diffuse_coefficient
    c0, c1 = 1.0 - 6.0 * k, k
    for it in range(cfg.float_density_diffuse_steps):
        src, dst = (a_f, b_f) if it % 2 == 0 else (b_f, a_f)
        left, right = planes(src, 1, group)
        for a, b in blocks:
            block = torch.cat([left if a == 0 else src[a - 1:a], src[a:b],
                               right if b == rows else src[b:b + 1]])
            blurred = c0 * src[a:b] + c1 * inner(
                neighbor_sum(block, moves=AXIS_MOVES))
            dst[a:b] = torch.where(skip[a:b], dst[a:b], blurred)
    return new, a_f, b_f


# ------------------------------------------------------------- the rank
def part(state: dict, scene: Scene, group) -> dict:
    """This rank's part of a seeded state whose grid fields are already
    its slab and whose particles are whole: `slots` rows holding, first
    and in index order, the active particles whose cell x lies in the
    slab; `slots` from a census of the whole set, the same on every rank
    (module docstring)."""
    r, n = _where(group)
    gx = scene.grid_size[0]
    lx = gx // n
    pos, act = state["positions"], state["active"]
    cx = float_to_index(torch.floor(pos[:, 0]))
    owner = torch.clamp(cx, 0, gx - 1) // lx
    census = torch.bincount(owner[act], minlength=n)
    peak = max(1, int(census.max()))
    slots = max(peak, int(-(-(peak * scene.particle_slot_slack) // 1)))
    slots = -(-slots // 128) * 128
    src = torch.nonzero(act & (owner == r)).squeeze(1)
    positions = torch.zeros((slots, 3), dtype=pos.dtype, device=pos.device)
    positions[:len(src)] = pos[src]
    active = torch.zeros((slots,), dtype=torch.bool, device=act.device)
    active[:len(src)] = True
    return dict(state, positions=positions, active=active)


@torch.no_grad()
def step(state: dict, cfg: Scene, dtype=torch.float32, group=None) -> dict:
    """One frame of this rank's part (`part`'s layout), in `reference/
    step.py`'s stage order, every rank of `group` calling it with its
    own.  Float fields are cast to `dtype` first, and every float stage
    computes in it.  TF32 is off, so that no matmul or convolution a later
    edit brings in computes below float32 (the step runs none today)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r, n = _where(group)
    gx = cfg.grid_size[0]
    if gx % n:
        raise ValueError(f"grid x size {gx} does not divide {n} ranks")
    lx = gx // n
    x0 = r * lx
    res = cfg.surface_render_resolution
    s = {k: (v.to(dtype) if k in FLOAT_FIELDS else v)
         for k, v in state.items()}
    if s["cell_types"].shape[0] != lx:
        raise ValueError(f"rank {r} holds {s['cell_types'].shape[0]} grid "
                         f"rows, not its slab's {lx}")
    old_types = s["cell_types"]
    types = classify(pool(s["detailed_occ"], res), cfg, x0, group)
    vel = extrapolate(old_types, types, s["velocity"], group)
    vel = advect(types, vel, cfg, x0, group)
    vel = apply_forces(types, vel, cfg, x0, group)
    vel = diffuse(types, vel, cfg, group)
    vel = apply_solids(types, vel, cfg, group)
    p = jacobi(types, divergence(vel, group), cfg, dtype, group)
    vel = project(types, p, vel, cfg, x0, group)
    del p
    pos = move_particles(vel, s["positions"], s["active"], cfg, x0, group)
    pos, active, drops = migrate(pos, s["active"], x0, lx,
                                 migrate_capacity(pos.shape[0], cfg), group)
    if n > 1:
        total = torch.tensor([drops], dtype=torch.int64, device=pos.device)
        dist.all_reduce(total, group=group)
        drops = int(total[0])
    occ = occupancy(pos, active, cfg, x0, lx)
    inertia, f1, f2 = surface_fields(types, occ, s["inertia"],
                                     s["float_dens_2"], cfg, dtype, group)
    return {"velocity": vel, "cell_types": types, "inertia": inertia,
            "float_dens_1": f1, "float_dens_2": f2, "positions": pos,
            "active": active, "detailed_occ": occ,
            "step": s["step"] + 1, "dropped": s["dropped"] + drops}
