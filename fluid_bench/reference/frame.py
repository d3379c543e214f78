"""The plain reference of one viewer frame: the marching-cubes mesh of the
surface field and the z-buffered splat image of particles and surface, as
the reference's render pass draws them (`31_render_surface`,
`30_render_particles`), with its camera (`main.cpp:128-133`).

A frozen copy of the arithmetic of the program's facade (its mesh
extraction and splat renderer), NumPy and plain PyTorch only, importing
nothing of the program.  The products and sums that the program rounds
once (fused multiply-adds) are rounded once here too (`fma`).
"""

from __future__ import annotations

import numpy as np
import torch

from fluid_bench.reference.mc_tables import (CORNERS, EDGES, MAX_TRIS,
                                             TRI_COUNTS, TRI_EDGES)
from fluid_bench.reference.step import float_to_index

INF_DEPTH = 3.4e38
HIT = 1 << 30
REFERENCE_VIEWPORT = 1400.0


# ---------------------------------------------------------------- rounding
def fma(a, b, c):
    """a * b + c of f32 tensors with one rounding: the exact f64 product,
    the f64 sum rounded to odd, then to f32."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact = torch.isfinite(s) & (err != 0)
    toward_zero = torch.where((err > 0) == (s > 0), s,
                              torch.nextafter(s, torch.zeros_like(s)))
    odd = (toward_zero.view(torch.int64) | 1).view(torch.float64)
    return torch.where(inexact, odd, s).float()


def sqrt(x):
    return torch.sqrt(x.double()).float()


# ------------------------------------------------------------------ camera
def camera_mvp(grid_size) -> np.ndarray:
    """The reference's pose scaled to the grid: eye (10, 10, -10) * s
    looking along +z, up -y, 45 degrees, near 0.1, far max(200, 200 s),
    the Vulkan y-flip folded in; projection @ view as float32."""
    s = max(grid_size) / 20.0
    pos = np.array((10.0 * s, 10.0 * s, -10.0 * s))
    f = np.array((0.0, 0.0, 1.0))
    up = np.array((0.0, -1.0, 0.0))
    side = np.cross(f, up)
    side = side / np.linalg.norm(side)
    u = np.cross(side, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = side, u, -f
    view[0, 3] = -np.dot(side, pos)
    view[1, 3] = -np.dot(u, pos)
    view[2, 3] = np.dot(f, pos)
    near, far = 0.1, max(200.0, 20.0 * s * 10)
    t = 1.0 / np.tan(np.radians(45.0) / 2.0)
    proj = np.zeros((4, 4))
    proj[0, 0] = t
    proj[1, 1] = -t
    proj[2, 2] = far / (near - far)
    proj[2, 3] = far * near / (near - far)
    proj[3, 2] = -1.0
    return (proj @ view).astype(np.float32)


# ---------------------------------------------------------- marching cubes
def default_max_cells(detailed_size) -> int:
    dx, dy, dz = detailed_size
    side = max(dx, dy, dz)
    return min(dx * dy * dz, max(4096, 8 * side * side))


def surface_field(f1, f2, blur_steps):
    """The n-th blur pass lands in f2 for odd n, in f1 for even n."""
    return f2 if blur_steps % 2 == 1 else f1


def mesh(field, res: int, max_cells: int):
    """(vertices (K*5, 3, 3), normals (K*5, 3), valid (K*5,)) of the
    0-isosurface of `field` over its cell grid: the crossing cells
    compacted in index order, cut to `max_cells`, padded with cell 0."""
    device = field.device
    dx, dy, dz = field.shape
    cx, cy, cz = dx - 1, dy - 1, dz - 1
    inside = field > 0
    config = torch.zeros((cx, cy, cz), dtype=torch.int32, device=device)
    for i, (ox, oy, oz) in enumerate(CORNERS.tolist()):
        bit = inside[ox:ox + cx, oy:oy + cy, oz:oz + cz]
        config = config | (bit.to(torch.int32) << i)
    config = config.reshape(-1).long()

    def table(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    counts = table(TRI_COUNTS)
    surface = counts[config] > 0
    n_cells = surface.sum()
    found = torch.nonzero(surface).reshape(-1)[:max_cells]
    cell_ids = torch.zeros(max_cells, dtype=torch.int64, device=device)
    cell_ids[:found.numel()] = found
    cell_valid = torch.arange(max_cells, device=device) < n_cells
    px = cell_ids // (cy * cz)
    py = (cell_ids // cz) % cy
    pz = cell_ids % cz
    flat = field.reshape(-1)
    dens = torch.stack([flat[(px + ox) * (dy * dz) + (py + oy) * dz + (pz + oz)]
                        for ox, oy, oz in CORNERS.tolist()], dim=-1)
    cfg_k = config[cell_ids]
    ntri = counts[cfg_k]
    tri_edge = table(TRI_EDGES)[cfg_k].reshape(-1, MAX_TRIS, 3)
    tri_edge = torch.where(tri_edge == 255, 0, tri_edge)
    ea = table(EDGES[:, 0])[tri_edge]
    eb = table(EDGES[:, 1])[tri_edge]
    dens_t = dens[:, None, :].expand(-1, MAX_TRIS, -1)
    d0 = torch.gather(dens_t, -1, ea)
    d1 = torch.gather(dens_t, -1, eb)
    alpha = d0 / (d0 - d1)
    corners = torch.from_numpy(CORNERS.astype(np.float32)).to(device)
    ca = corners[ea]
    cb = corners[eb]
    cell_pos = torch.stack([px, py, pz], dim=-1).to(torch.float32)
    # / res as a product with the f32 reciprocal
    verts = ((0.5 + cell_pos[:, None, None, :] + ca + (cb - ca)
              * alpha[..., None]) * float(np.float32(1.0) / np.float32(res)))
    a = verts[:, :, 1] - verts[:, :, 0]
    b = verts[:, :, 2] - verts[:, :, 0]
    n = torch.stack([fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))
                     for i, j in ((1, 2), (2, 0), (0, 1))], dim=-1)
    sq = fma(n[..., 2], n[..., 2], fma(n[..., 1], n[..., 1],
                                       n[..., 0] * n[..., 0]))
    n = n / torch.clamp(sqrt(sq), min=1e-20)[..., None]
    slot = torch.arange(MAX_TRIS, device=device)[None, :]
    valid = cell_valid[:, None] & (slot < ntri[:, None])
    return verts.reshape(-1, 3, 3), n.reshape(-1, 3), valid.reshape(-1)


# -------------------------------------------------------------------- splat
def _project(m, points, width, height):
    x, y, z = points[:, 0:1], points[:, 1:2], points[:, 2:3]
    clip = (x * m[:, 0] + y * m[:, 1]) + (z * m[:, 2] + m[:, 3])
    w = clip[:, 3]
    front = w > 1e-6
    ndc = clip[:, :3] / torch.clamp(w, min=1e-6)[:, None]
    return ((ndc[:, 0] * 0.5 + 0.5) * width, (ndc[:, 1] * 0.5 + 0.5) * height,
            w, front)


def _flat(px, py, width, height, valid):
    xi = float_to_index(torch.floor(px), torch.int32).long()
    yi = float_to_index(torch.floor(py), torch.int32).long()
    ok = valid & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    return torch.where(ok, yi * width + xi, 0), ok


def _lattice(subdiv):
    pts = [(i / subdiv, j / subdiv, (subdiv - i - j) / subdiv)
           for i in range(subdiv + 1) for j in range(subdiv + 1 - i)]
    return np.array(pts, dtype=np.float32)


def image(positions, active, tris, normals, valid, mvp, colors: dict,
          width: int, height: int, subdiv: int = 4, max_radius: int = 3,
          fine_budget: int = 65536):
    """(H, W, 3) uint8: the surface triangles sampled on barycentric
    lattices (the largest on screen re-sampled finer), then particle
    sprites of min(size / depth, max) px on a 1400 px viewport, resolved by
    a scatter-min of depth and a scatter-max of packed colours."""
    w, h = width, height
    device = positions.device

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    m = f32(mvp)
    passes = []
    if tris is not None:
        light = np.asarray(colors["light"], dtype=np.float32)
        light = f32(light / np.linalg.norm(light))
        dot = normals[:, 0] * light[0]
        for k in (1, 2):
            dot = fma(normals[:, k], light[k], dot)
        lam = torch.clamp(-dot, min=0.0)
        tri_color = fma(lam[:, None], f32(colors["diffuse"])[None, :],
                        f32(colors["ambient"])[None, :])
        vx, vy, _, vfront = _project(m, tris.reshape(-1, 3), w, h)
        vx, vy, vfront = (t.reshape(-1, 3) for t in (vx, vy, vfront))
        big = 1e9
        ext = torch.maximum(
            torch.where(vfront, vx, -big).amax(1)
            - torch.where(vfront, vx, big).amin(1),
            torch.where(vfront, vy, -big).amax(1)
            - torch.where(vfront, vy, big).amin(1))
        ext = torch.where(valid & vfront.any(1), ext, 0.0)

        def lattice_pass(sel_tris, sel_colors, sel_valid, sub):
            keep = torch.nonzero(sel_valid).reshape(-1)
            bary = f32(_lattice(sub))
            b = bary[None, :, :, None]
            t = sel_tris[keep][:, None, :, :]
            pts = b[:, :, 0] * t[:, :, 0]
            for k in (1, 2):
                pts = fma(b[:, :, k], t[:, :, k], pts)
            px, py, d, front = _project(m, pts.reshape(-1, 3), w, h)
            col = torch.repeat_interleave(sel_colors[keep], bary.shape[0],
                                          dim=0)
            passes.append((px, py, d, front, col))

        lattice_pass(tris, tri_color, valid, subdiv)
        for threshold, budget, sub in ((float(subdiv), fine_budget, 10),
                                       (10.0, max(1, fine_budget // 4), 24)):
            masked = torch.where(valid & (ext > threshold), ext, -1.0)
            vals, ids = torch.sort(masked, descending=True, stable=True)
            k = min(budget, masked.shape[0])
            vals, ids = vals[:k], ids[:k]
            lattice_pass(tris[ids], tri_color[ids], vals > 0.0, sub)

    px, py, d, front = _project(m, positions, w, h)
    pcol = f32(colors["particle"]).expand(positions.shape[0], 3)
    size_px = torch.clamp(torch.full_like(d, colors["particle_size"])
                          / torch.clamp(d, min=1e-6),
                          max=colors["particle_max_size"])
    r_px = torch.clamp(0.5 * size_px * (min(w, h) / REFERENCE_VIEWPORT),
                       0.0, float(max_radius))
    r = torch.clamp(r_px, min=0.5)
    r2 = r * r
    rmax = max_radius
    for dx in range(-rmax, rmax + 1):
        for dy in range(-rmax, rmax + 1):
            if dx * dx + dy * dy > rmax * rmax:
                continue
            if dx == 0 and dy == 0:
                passes.append((px, py, d, active & front, pcol))
                continue
            lit = (dx * dx + dy * dy) <= r2
            passes.append((px + dx, py + dy, d, active & front & lit, pcol))

    depth = torch.full((w * h,), INF_DEPTH, dtype=torch.float32, device=device)
    for ppx, ppy, pd, pv, _ in passes:
        idx, ok = _flat(ppx, ppy, w, h, pv)
        depth = depth.scatter_reduce(0, idx, torch.where(ok, pd, INF_DEPTH),
                                     "amin")
    color = torch.zeros((w * h,), dtype=torch.int32, device=device)
    for ppx, ppy, pd, pv, pc in passes:
        idx, ok = _flat(ppx, ppy, w, h, pv)
        won = ok & (pd <= depth[idx] * (1 + 1e-6))
        rgb = torch.clamp(pc * 255, 0, 255)
        rgb = torch.where(torch.isnan(rgb), 0.0, rgb).to(torch.int32)
        packed = rgb[:, 0] << 16 | rgb[:, 1] << 8 | rgb[:, 2]
        color = color.scatter_reduce(0, idx, torch.where(won, packed | HIT, 0),
                                     "amax")
    bg = torch.as_tensor((np.asarray(colors["background"]) * 255)
                         .astype(np.uint8), device=device)
    rgb = torch.stack([(color >> 16) & 0xFF, (color >> 8) & 0xFF,
                       color & 0xFF], dim=-1).to(torch.uint8)
    hit = ((color >> 30) & 1) == 1
    return torch.where(hit[:, None], rgb, bg[None, :]).reshape(h, w, 3)


@torch.no_grad()
def frame(state: dict, fields: dict, width: int, height: int):
    """(image (H, W, 3) uint8, (vertices, normals, valid)) of `state`
    seen from the reference camera, particles and surface drawn."""
    res = fields["surface_render_resolution"]
    dsize = tuple(s * res for s in fields["grid_size"])
    field = surface_field(state["float_dens_1"], state["float_dens_2"],
                          fields["float_density_diffuse_steps"])
    verts, normals, valid = mesh(field, res, default_max_cells(dsize))
    colors = {"light": fields["render_light_direction"],
              "ambient": fields["render_surface_ambient_color"],
              "diffuse": fields["render_surface_diffuse_color"],
              "particle": fields["particle_render_color"],
              "particle_size": fields["particle_render_size"],
              "particle_max_size": fields["particle_render_max_size"],
              "background": fields["background_color"]}
    img = image(state["positions"], state["active"], verts, normals, valid,
                camera_mvp(fields["grid_size"]), colors, width, height)
    return img, (verts, normals, valid)
