"""The plain reference of one simulation step: the reference's 19 stages
(`fluid_flow_sections.h:159-391` of the Vulkan original) in plain PyTorch,
one elementwise operation after another, with no kernel, no graph and no
fused stage.

It is a frozen copy of the arithmetic of the program's plain stage path
(the path the program takes with its kernels switched off), kept here so
that the benchmark's judgement does not move when the program does.  It
imports nothing of the program: it reads a configuration as the plain
dictionary of the benchmark's configuration file, and a state as a dict of
tensors with the program's field names.

`dtype` is the floating type every float field and every float stage
computes in.  float32 is the configuration's own precision; the benchmark's
control runs it in bfloat16 (`fluid_bench/control.py`).

Only the options the benchmark's configurations use are implemented; any
other raises, so that a configuration the reference cannot judge is never
judged by it.
"""

from __future__ import annotations

import torch

INACTIVE, AIR, WATER, SOLID = 0, 1, 2, 3

MOVES = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0), (0, -1, 0), (0, 0, -1))
AXIS_MOVES = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
              (0, 0, -1))
FIELDS = ("velocity", "cell_types", "inertia", "float_dens_1",
          "float_dens_2", "positions", "active", "detailed_occ", "step",
          "dropped")
FLOAT_FIELDS = ("velocity", "float_dens_1", "float_dens_2", "positions")

# the options this reference implements, and the value each must have
SUPPORTED = {
    "volume_correction": 0.0, "surface_method": "inertia",
    "pressure_solver": "jacobi", "particle_sampler": "packed",
    "surface_enabled": True, "dtype": "float32",
    "particle_sharding": "index",
}


class Scene:
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

    def __getattr__(self, name):
        try:
            return self.__dict__["f"][name]
        except KeyError:
            raise AttributeError(name) from None

    @property
    def fountain(self):
        if self.f.get("fountain_position") is not None:
            return tuple(self.f["fountain_position"])
        w, h, d = self.grid_size
        return (w // 2, h - 2, d // 2)

    @property
    def detailed_size(self):
        r = self.surface_render_resolution
        return tuple(s * r for s in self.grid_size)

    @property
    def inertia_dtype(self):
        return torch.uint8 if 0 < self.max_inertia <= 255 else torch.int32


# --------------------------------------------------------------- helpers
def shifted(a, offset, fill=0):
    """out[i] = a[i + offset] over the last three axes, `fill` outside."""
    if all(off == 0 for off in offset):
        return a
    out = torch.full_like(a, fill)
    src = [slice(None)] * a.ndim
    dst = [slice(None)] * a.ndim
    for k, off in enumerate(offset):
        ax = a.ndim - 3 + k
        n = a.shape[ax]
        if abs(off) >= n:
            return out
        if off > 0:
            src[ax], dst[ax] = slice(off, n), slice(0, n - off)
        elif off < 0:
            src[ax], dst[ax] = slice(0, n + off), slice(-off, n)
    out[tuple(dst)] = a[tuple(src)]
    return out


def edge_shifted(a, offset):
    """out[i] = a[clip(i + offset)] over the first three axes."""
    for ax, off in enumerate(offset):
        if off:
            n = a.shape[ax]
            idx = torch.clamp(torch.arange(n, device=a.device) + off, 0, n - 1)
            a = a.index_select(ax, idx)
    return a


def axis_nonzero(shape, c, device):
    idx = torch.arange(shape[c], device=device)
    return (idx != 0).reshape(tuple(-1 if k == c else 1 for k in range(3)))


def div_scalar(a, b):
    """IEEE a / b: the divisor as a tensor on the device, as a division by
    a tensor is computed on the card (a Python divisor is multiplied by
    its reciprocal there)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def neighbor_sum(a, fill=0, moves=MOVES):
    out = None
    for mv in moves:
        s = shifted(a, mv, fill=fill)
        out = s if out is None else out + s
    return out


def float_to_index(x, dtype=torch.int64):
    """Toward zero, a NaN as 0, values beyond the type at its bounds."""
    info = torch.iinfo(dtype)
    limit = 2.0 ** (info.bits - 1)
    big = x >= limit
    small = x < -limit
    inside = torch.where(big | small | torch.isnan(x), 0.0, x).to(dtype)
    return torch.where(big, info.max, torch.where(small, info.min, inside))


# ------------------------------------------------- stages 01-06: cell types
def occupancy(positions, active, res, detailed_size):
    """Stage 15 (and the next step's 01): 0/1 u8 occupancy of the detailed
    grid at the truncated index pos * res; inactive and out-of-grid
    particles dropped, never clamped."""
    dx, dy, dz = detailed_size
    idx = float_to_index(torch.trunc(positions * float(res)))
    x, y, z = idx[:, 0], idx[:, 1], idx[:, 2]
    inb = ((x >= 0) & (x < dx) & (y >= 0) & (y < dy) & (z >= 0) & (z < dz)
           & active)
    n = dx * dy * dz
    flat = torch.where(inb, x * (dy * dz) + y * dz + z, n)
    occ = torch.zeros(n + 1, dtype=torch.uint8, device=positions.device)
    occ.index_fill_(0, flat, 1)
    return occ[:n].reshape(dx, dy, dz)


def pool(occ, r):
    dx, dy, dz = occ.shape
    return occ.reshape(dx // r, r, dy // r, r, dz // r, r).amax(dim=(1, 3, 5))


def solid_mask(shape, cfg, device):
    gx, gy, gz = shape
    ix = torch.arange(gx, device=device)[:, None, None]
    iy = torch.arange(gy, device=device)[None, :, None]
    iz = torch.arange(gz, device=device)[None, None, :]
    mask = ((ix == 0) | (ix == gx - 1) | (iy == 0) | (iy == gy - 1)
            | (iz == 0) | (iz == gz - 1))
    for (x0, y0, z0), (x1, y1, z1) in cfg.solid_boxes:
        mask = mask | ((ix >= x0) & (ix < x1) & (iy >= y0) & (iy < y1)
                       & (iz >= z0) & (iz < z1))
    return mask


def classify(occ_sim, cfg):
    """Stages 02-03: WATER where occupied; then the static solids SOLID and
    the non-water cells beside water AIR."""
    types = torch.where(occ_sim > 0, WATER, INACTIVE).to(torch.uint8)
    solid = solid_mask(types.shape, cfg, types.device)
    water = types == WATER
    around = torch.zeros_like(water)
    for mv in MOVES:
        around = around | shifted(water, mv, fill=False)
    air = (~water) & around
    wet = torch.where(air, torch.full_like(types, AIR), types)
    return torch.where(solid, torch.full_like(types, SOLID), wet)


def _active_cells(types):
    return (types == WATER) | (types == AIR)


def extrapolate(old_types, new_types, vel):
    """Stages 04-05: the mean of the old WATER neighbours' velocities on
    faces that become active; faces that stop being active reset to 0."""
    water = old_types == WATER
    vsum = torch.zeros_like(vel)
    count = torch.zeros(old_types.shape, dtype=vel.dtype, device=vel.device)
    for mv in MOVES:
        w = shifted(water, mv, fill=False)
        count = count + w
        vsum = vsum + shifted(vel, mv) * w
    ext = torch.where(count > 0, vsum / torch.clamp(count, min=1), 0.0)
    was_here = _active_cells(old_types)
    is_here = _active_cells(new_types)
    out = []
    for c in range(3):
        mv = tuple(-1 if k == c else 0 for k in range(3))
        was = was_here | shifted(was_here, mv, fill=False)
        is_ = is_here | shifted(is_here, mv, fill=False)
        out.append(torch.where(was & ~is_, 0.0,
                               torch.where(~was & is_, ext[c], vel[c])))
    return torch.stack(out)


# ------------------------------------------------------- stage 07: advect
def _face_center_velocity(vel, c):
    comps = []
    for cp in range(3):
        if cp == c:
            comps.append(vel[c])
            continue
        acc = torch.zeros_like(vel[cp])
        for dc in (-1, 0):
            for dcp in (0, 1):
                off = [0, 0, 0]
                off[c] = dc
                off[cp] = dcp
                acc = acc + edge_shifted(vel[cp], tuple(off))
        comps.append(0.25 * acc)
    return torch.stack(comps)


def advect(types, vel, cfg):
    """Stage 07: semi-Lagrangian advection as a hat-weighted sum over every
    offset |delta| <= R of edge-replicated shifts, the displacement clamped
    to [-R, R - 1e-4] and the point to the grid; applied to component c of
    cell i iff i_c != 0 and i or i + e_c is WATER."""
    r = cfg.advect_max_displacement
    dt = cfg.dt
    gx, gy, gz = types.shape
    water = types == WATER
    idx = torch.clamp(torch.arange(-r, gx + r, device=vel.device), 0, gx - 1)
    vx = vel.index_select(1, idx)
    out = []
    for c in range(3):
        up = tuple(1 if k == c else 0 for k in range(3))
        cond = ((water | shifted(water, up, fill=False))
                & axis_nonzero(types.shape, c, types.device))
        u = -_face_center_velocity(vx, c)[:, r:r + gx] * dt
        u = torch.clamp(u, -r, r - 1e-4)
        axes = []
        for d, n in enumerate((gx, gy, gz)):
            i_d = torch.arange(n, dtype=vx.dtype, device=vx.device).reshape(
                tuple(-1 if k == d else 1 for k in range(3)))
            t_d = torch.clamp(i_d + u[d], 0.0, n - 1.0)
            u_d = t_d - i_d
            o_d = torch.floor(u_d)
            f_d = u_d - o_d
            axes.append([torch.where(o_d == delta, 1.0 - f_d, 0.0)
                         + torch.where(o_d == delta - 1, f_d, 0.0)
                         for delta in range(-r, r + 1)])
        wx, wy, wz = axes
        padded = vx[c]
        for ax in (1, 2):
            n = padded.shape[ax]
            pidx = torch.clamp(torch.arange(-r, n + r, device=vel.device),
                               0, n - 1)
            padded = padded.index_select(ax, pidx)
        acc = torch.zeros(types.shape, dtype=vx.dtype, device=vx.device)
        for ax, dxo in enumerate(range(-r, r + 1)):
            for ay, dyo in enumerate(range(-r, r + 1)):
                wxy = wx[ax] * wy[ay]
                for az, dzo in enumerate(range(-r, r + 1)):
                    sl = padded[r + dxo:r + dxo + gx, r + dyo:r + dyo + gy,
                                r + dzo:r + dzo + gz]
                    acc = acc + (wxy * wz[az]) * sl
        out.append(torch.where(cond, acc, vx[c, r:r + gx]))
    return torch.stack(out)


# ------------------------------------------------ stages 08-10: forces
def apply_forces(types, vel, cfg):
    """Stage 08: gravity on wet y-faces, the fountain and the extra
    forces (+y is down)."""
    water = types == WATER
    wet_face = water | shifted(water, (0, -1, 0), fill=False)
    ynz = axis_nonzero(types.shape, 1, types.device)
    force = torch.where(wet_face & ynz, cfg.gravity, 0.0).to(vel.dtype)
    fountain = torch.zeros(types.shape, dtype=torch.bool, device=vel.device)
    fountain[cfg.fountain].fill_(True)
    force = force + torch.where(fountain & wet_face, cfg.fountain_force,
                                0.0).to(vel.dtype)
    out = vel.clone()
    out[1] = vel[1] + cfg.dt * force
    for cell, fvec in cfg.extra_forces:
        at = torch.zeros(types.shape, dtype=torch.bool, device=vel.device)
        at[tuple(cell)].fill_(True)
        for c in range(3):
            if fvec[c] == 0.0:
                continue
            mv = tuple(-1 if k == c else 0 for k in range(3))
            wet_c = water | shifted(water, mv, fill=False)
            out[c] = out[c] + torch.where(at & wet_c, cfg.dt * fvec[c],
                                          0.0).to(vel.dtype)
    return out


def diffuse(types, vel, cfg):
    """Stage 09: the reference's shader writes a shadowed local, so with
    `reference_diffuse_noop` the stage is a copy."""
    if cfg.reference_diffuse_noop:
        return vel
    k = cfg.diffusion_coefficient * cfg.dt
    nsum = torch.zeros_like(vel)
    for mv in MOVES:
        nsum = nsum + shifted(vel, mv)
    diffused = (1.0 - 6.0 * k) * vel + k * nsum
    return torch.where((types == WATER)[None], diffused, vel)


def apply_solids(types, vel, cfg):
    """Stage 10: SOLID cells push out at least `repel`."""
    r = cfg.solid_repel_velocity
    solid = types == SOLID
    out = []
    for c in range(3):
        v = vel[c]
        v = torch.where(solid & (v > -r), -r, v)
        mv = tuple(-1 if k == c else 0 for k in range(3))
        v = torch.where(shifted(solid, mv, fill=False) & (v < r), r, v)
        out.append(v)
    return torch.stack(out)


# --------------------------------------------- stages 11-13: pressure
def divergence(vel):
    div = torch.zeros(vel.shape[1:], dtype=vel.dtype, device=vel.device)
    for c in range(3):
        up = tuple(1 if k == c else 0 for k in range(3))
        div = div + shifted(vel[c], up) - vel[c]
    return div


def jacobi(types, div, cfg, dtype):
    """Stage 12: jacobi_iters - 1 sweeps (the reference's projection reads
    its 199th of 200 iterates) of the folded Jacobi iteration
    q' = rd * sum_6(q) + c2e on WATER cells, from the air pressure."""
    boundary = cfg.air_pressure
    b = div.to(dtype) * (cfg.fluid_density * cfg.cell_width / cfg.dt)
    iters = cfg.jacobi_iters - (1 if cfg.reference_pressure_parity else 0)
    water = types == WATER
    solid = types == SOLID
    aii = torch.zeros(types.shape, dtype=dtype, device=types.device)
    n_air = torch.zeros_like(aii)
    for mv in MOVES:
        nb_solid = shifted(solid, mv, fill=False)
        nb_water = shifted(water, mv, fill=False)
        aii = aii + (~nb_solid)
        n_air = n_air + (~nb_solid & ~nb_water)
    const = n_air * boundary - b.to(dtype)
    code = torch.where(water & (aii > 0), aii, 0.0).to(torch.uint8)
    q0 = torch.where(water, boundary, 0.0).to(dtype)
    c2 = const / torch.clamp(aii, min=1.0)
    codef = code.to(torch.int32).to(dtype)
    rd = torch.where(codef > 0,
                     torch.ones_like(codef) / torch.clamp(codef, min=1.0),
                     0.0)
    c2e = torch.where(code > 0, c2, q0)
    q = q0
    for _ in range(iters):
        q = rd * neighbor_sum(q, moves=AXIS_MOVES) + c2e
    return torch.where(water, q, boundary)


def project(types, p, vel, cfg):
    """Stage 13: v_c(i) -= dt/(rho dx) (p(i) - p(i - e_c)) where i_c != 0,
    one of the two cells is WATER and neither is SOLID."""
    water = types == WATER
    solid = types == SOLID
    scale = cfg.dt / (cfg.fluid_density * cfg.cell_width)
    out = []
    for c in range(3):
        mv = tuple(-1 if k == c else 0 for k in range(3))
        cond = (axis_nonzero(types.shape, c, types.device)
                & (water | shifted(water, mv, fill=False))
                & ~solid & ~shifted(solid, mv, fill=False))
        grad = p - shifted(p, mv)
        dv = torch.where(cond, grad, 0.0).to(vel.dtype)
        out.append(vel[c] - scale * dv)
    return torch.stack(out)


# ------------------------------------------------ stage 14: move particles
_OTHER = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def _lane(c, dc, d1, d2):
    return c * 18 + dc * 9 + (d1 + 1) * 3 + (d2 + 1)


def move_particles(vel, pos, active, dt):
    """Stage 14: forward Euler through the staggered trilinear velocity,
    read from a 64-lane table of each cell's neighbourhood and accumulated
    lane by lane (component c: offsets {0, 1} along c and {-1, 0, 1} along
    the two others)."""
    gx, gy, gz = vel.shape[1:]
    zero = torch.zeros_like(vel[0])
    lanes = [zero] * 64
    for c in range(3):
        a1, a2 = _OTHER[c]
        for dc in (0, 1):
            for d1 in (-1, 0, 1):
                for d2 in (-1, 0, 1):
                    off = [0, 0, 0]
                    off[c] = dc
                    off[a1] = d1
                    off[a2] = d2
                    lanes[_lane(c, dc, d1, d2)] = edge_shifted(vel[c],
                                                               tuple(off))
    table = torch.stack(lanes, dim=-1).reshape(gx * gy * gz, 64)
    grid = (gx, gy, gz)
    j = float_to_index(torch.floor(pos))
    j = torch.stack([torch.clamp(j[:, d], 0, grid[d] - 1) for d in range(3)],
                    dim=-1)
    rows = table.index_select(0, j[:, 0] * (gy * gz) + j[:, 1] * gz + j[:, 2])
    top = [float(g) - 1.0 for g in grid]
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


# ------------------------------------------- stages 16-18: surface fields
def surface_fields(types, occ, inertia, f2, cfg, dtype):
    """Stages 16-18: the inertia update in int32, the signed field
    nzi * (I / div) + (nzi - 1), then `float_density_diffuse_steps`
    ping-pong blur passes (x+1, x-1, y+1, y-1, z+1, z-1 neighbours, 0
    outside) in which cells under a SOLID parent keep their value."""
    skip = types == SOLID
    r = cfg.surface_render_resolution
    for ax in range(3):
        skip = torch.repeat_interleave(skip, r, dim=ax)
    filled = torch.clamp(occ.to(torch.int32), max=1)
    hits = neighbor_sum(filled, moves=AXIS_MOVES)
    ge = torch.clamp(hits - (cfg.inertia_required_neighbour_hits - 1), 0, 1)
    inc = (filled * cfg.inertia_increase_filled
           + ge * hits * cfg.inertia_increase_neighbour)
    nz = torch.clamp(inc, 0, 1)
    old = inertia.to(torch.int32)
    increased = old + inc
    decreased = torch.clamp(old - cfg.inertia_decrease, min=0)
    new = torch.clamp(decreased + nz * (increased - decreased),
                      max=cfg.max_inertia)
    nzi = torch.clamp(new, 0, 1).to(dtype)
    a = nzi * div_scalar(new.to(dtype),
                         cfg.float_density_division_coefficient) + (nzi - 1.0)
    b = f2
    k = cfg.float_density_diffuse_coefficient
    c0, c1 = 1.0 - 6.0 * k, k
    for it in range(cfg.float_density_diffuse_steps):
        src, dst = (a, b) if it % 2 == 0 else (b, a)
        blurred = c0 * src + c1 * neighbor_sum(src, moves=AXIS_MOVES)
        res = torch.where(skip, dst, blurred)
        if it % 2 == 0:
            b = res
        else:
            a = res
    return new.to(inertia.dtype), a, b


# ------------------------------------------------------------- the step
@torch.no_grad()
def step(state: dict, cfg: Scene, dtype=torch.float32) -> dict:
    """One frame from `state` (a dict of the program's fields): stages
    01-18 in the reference's order.  Float fields are cast to `dtype`
    first, and every float stage computes in it."""
    s = {k: (v.to(dtype) if k in FLOAT_FIELDS else v)
         for k, v in state.items()}
    old_types = s["cell_types"]
    new_types = classify(pool(s["detailed_occ"], cfg.surface_render_resolution),
                         cfg)
    vel = extrapolate(old_types, new_types, s["velocity"])
    types = new_types
    vel = advect(types, vel, cfg)
    vel = apply_forces(types, vel, cfg)
    vel = diffuse(types, vel, cfg)
    vel = apply_solids(types, vel, cfg)
    p = jacobi(types, divergence(vel), cfg, dtype)
    vel = project(types, p, vel, cfg)
    pos = move_particles(vel, s["positions"], s["active"], cfg.dt)
    occ = occupancy(pos, s["active"], cfg.surface_render_resolution,
                    cfg.detailed_size)
    inertia, f1, f2 = surface_fields(types, occ, s["inertia"],
                                     s["float_dens_2"], cfg, dtype)
    return {"velocity": vel, "cell_types": types, "inertia": inertia,
            "float_dens_1": f1, "float_dens_2": f2, "positions": pos,
            "active": s["active"], "detailed_occ": occ,
            "step": s["step"] + 1, "dropped": s["dropped"]}
