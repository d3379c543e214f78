"""Headless rendering on the device: z-buffered point and sample splatting
(`tpu_fluid.render.splat`).

Replaces the reference's two graphics pipelines with scatter passes that
produce an RGB image on the card:

 - particle pass (reference `30_render_particles/render.vert:28-45` +
   `render.frag:20-26`): one point per active particle, screen size
   min(base/depth, max) pixels, drawn as a circle in the particle color,
   depth tested against the surface;
 - surface pass (reference `31_render_surface` raster stage): the marching-
   cubes triangles are densely sampled (fixed barycentric pattern per
   triangle) and each sample splats with the triangle's flat-shaded color
   `ambient + max(0, dot(-L, N)) * diffuse`
   (`render_surface.frag:21-26`).

Depth resolution uses two scatter passes: a scatter-min builds the depth
buffer, then a scatter-max of packed colors writes every sample that won
its pixel.  The packed color (hit bit at bit 30, RGB below) fits int32.

The arithmetic is that of the JAX package's jitted frame on XLA:CPU, so
the two packages draw the same pixels: the projection's product with the
MVP adds its four terms pairwise, the shading's and the lattice's small
products accumulate by fused multiply-adds (`ops/rounding.fma`), and the
shaded color is one fused multiply-add.  Among triangles of equal extent
the refinement passes take the lower index first, as `jax.lax.top_k`.
Only the valid triangles are sampled, where JAX samples every slot of the
fixed-capacity mesh: the frame is the same (`lattice_pass`).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.ops.indexing import float_to_index
from tpu_fluid_torch.ops.rounding import fma

INF_DEPTH = 3.4e38
HIT = 1 << 30


def _f32(values, device) -> torch.Tensor:
    """An f32 tensor on `device` from a tensor, an array or a tuple."""
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def project(mvp: torch.Tensor, points: torch.Tensor, width: int,
            height: int):
    """points (N,3) world -> (pixel_x, pixel_y, view_depth, in_front)."""
    m = mvp
    x, y, z = points[:, 0:1], points[:, 1:2], points[:, 2:3]
    # p @ mvp.T with p = (x, y, z, 1), its terms added pairwise
    clip = (x * m[:, 0] + y * m[:, 1]) + (z * m[:, 2] + m[:, 3])
    w = clip[:, 3]
    in_front = w > 1e-6
    ndc = clip[:, :3] / torch.clamp(w, min=1e-6)[:, None]
    px = (ndc[:, 0] * 0.5 + 0.5) * width
    py = (ndc[:, 1] * 0.5 + 0.5) * height
    return px, py, w, in_front


def _flat(px, py, width, height, valid):
    # XLA's conversion: a NaN pixel coordinate is pixel 0, a huge one
    # saturates
    xi = float_to_index(torch.floor(px), torch.int32).long()
    yi = float_to_index(torch.floor(py), torch.int32).long()
    ok = valid & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    return torch.where(ok, yi * width + xi, 0), ok


def splat_depth(depth_buf, px, py, depth, valid, width, height):
    idx, ok = _flat(px, py, width, height, valid)
    d = torch.where(ok, depth, INF_DEPTH)
    return depth_buf.scatter_reduce(0, idx, d, "amin")


def splat_color(color_buf, depth_buf, px, py, depth, color, valid,
                width, height, tol=1e-6):
    """Write color where this sample's depth equals the depth-buffer
    winner."""
    idx, ok = _flat(px, py, width, height, valid)
    won = ok & (depth <= depth_buf[idx] * (1 + tol))
    # scatter-max on a packed RGB word; ties pick the larger packed value
    rgb = torch.clamp(color * 255, 0, 255)
    rgb = torch.where(torch.isnan(rgb), 0.0, rgb).to(torch.int32)
    packed = rgb[:, 0] << 16 | rgb[:, 1] << 8 | rgb[:, 2]
    packed = torch.where(won, packed | HIT, 0)
    return color_buf.scatter_reduce(0, idx, packed, "amax")


def _bary_lattice(subdiv: int) -> np.ndarray:
    """Barycentric sample lattice: all (i,j,k)/S with i+j+k = S —
    (S+1)(S+2)/2 points covering the triangle evenly."""
    pts = []
    for i in range(subdiv + 1):
        for j in range(subdiv + 1 - i):
            k = subdiv - i - j
            pts.append((i / subdiv, j / subdiv, k / subdiv))
    return np.array(pts, dtype=np.float32)


def _lattice_points(bary: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """einsum("sk,tkd->tsd", bary, tris), accumulated by fused
    multiply-adds over k as XLA:CPU's dot does: (T, S, 3)."""
    b = bary[None, :, :, None]                 # (1, S, 3, 1)
    t = tris[:, None, :, :]                    # (T, 1, 3, 3)
    acc = b[:, :, 0] * t[:, :, 0]
    for k in (1, 2):
        acc = fma(b[:, :, k], t[:, :, k], acc)
    return acc


def top_extents(ext: torch.Tensor, k: int):
    """The k largest values and their indices, equal values in index
    order, as `jax.lax.top_k` (torch.topk leaves the order of ties
    open)."""
    vals, ids = torch.sort(ext, descending=True, stable=True)
    return vals[:k], ids[:k]


REFERENCE_VIEWPORT = 1400.0  # the reference's window edge (main.cpp:35)


def render_particles_and_surface(positions, active, tris, tri_normals,
                                 tri_valid, mvp, cfg: FluidConfig,
                                 width: int = 1024, height: int = 1024,
                                 surface_subdiv: int = 4,
                                 particle_radius: int | None = None,
                                 max_sprite_radius: int = 3,
                                 fine_tri_budget: int = 65536):
    """Full frame: surface triangles (screen-adaptive sample splat) +
    depth-scaled particle sprites, on the device of `positions`.

    tris: (T, 3, 3) world-space triangles (masked by tri_valid); pass
    tris=None to skip the surface pass.  Returns (H, W, 3) uint8.

    particle_radius=None (default) scales each sprite with depth like the
    reference's `gl_PointSize = min(base/w, max)` (`30_render_particles/
    render.vert:33-35`), normalized from its 1400px window to this viewport
    and capped at `max_sprite_radius` px radius (caps the splat pass
    count); an int pins every sprite to that fixed pixel radius.

    Surface triangles whose projection exceeds the base lattice's ~1px
    sample spacing are re-sampled through two finer masked lattices
    (triangles compacted to `fine_tri_budget` / 1/4th of it first), so
    large near-camera triangles leave no pixel holes.
    """
    w, h = width, height
    device = positions.device
    mvp = _f32(mvp, device)
    depth = torch.full((w * h,), INF_DEPTH, dtype=torch.float32,
                       device=device)
    color = torch.zeros((w * h,), dtype=torch.int32, device=device)

    passes = []  # (px, py, depth, valid, color_rgb)

    # --- surface samples --------------------------------------------------
    if tris is not None:
        light = np.asarray(cfg.render_light_direction, dtype=np.float32)
        light = _f32(light / np.linalg.norm(light), device)
        # tri_normals @ light by fused multiply-adds, as XLA:CPU's dot
        dot = tri_normals[:, 0] * light[0]
        for k in (1, 2):
            dot = fma(tri_normals[:, k], light[k], dot)
        lam = torch.clamp(-dot, min=0.0)
        amb = _f32(cfg.render_surface_ambient_color, device)
        dif = _f32(cfg.render_surface_diffuse_color, device)
        tri_color = fma(lam[:, None], dif[None, :], amb[None, :])  # (T, 3)

        # per-triangle projected extent (px): max abs vertex-pair delta over
        # the FRONT vertices only, so partially-clipped near-camera triangles
        # still refine
        vx, vy, _, vfront = project(mvp, tris.reshape(-1, 3), w, h)
        vx = vx.reshape(-1, 3)
        vy = vy.reshape(-1, 3)
        vfront = vfront.reshape(-1, 3)
        big = 1e9
        ext = torch.maximum(
            torch.where(vfront, vx, -big).amax(1)
            - torch.where(vfront, vx, big).amin(1),
            torch.where(vfront, vy, -big).amax(1)
            - torch.where(vfront, vy, big).amin(1))
        ext = torch.where(tri_valid & vfront.any(1), ext, 0.0)

        def lattice_pass(sel_tris, sel_colors, sel_valid, subdiv):
            # only the valid triangles are sampled: an invalid sample
            # scatters INF_DEPTH and 0 onto pixel 0, which changes
            # nothing, so the frame is the one JAX's fixed shapes give
            keep = torch.nonzero(sel_valid).reshape(-1)
            bary = _f32(_bary_lattice(subdiv), device)
            pts = _lattice_points(bary, sel_tris[keep])
            px, py, d, front = project(mvp, pts.reshape(-1, 3), w, h)
            col = torch.repeat_interleave(sel_colors[keep], bary.shape[0],
                                          dim=0)
            passes.append((px, py, d, front, col))

        # base lattice: hole-free for triangles up to ~subdiv px
        lattice_pass(tris, tri_color, tri_valid, surface_subdiv)

        # adaptive refinement: the triangles that project larger, largest
        # first, re-sampled through finer lattices
        for threshold, budget, subdiv in (
                (float(surface_subdiv), fine_tri_budget, 10),
                (10.0, max(1, fine_tri_budget // 4), 24)):
            ext_masked = torch.where(tri_valid & (ext > threshold), ext,
                                     -1.0)
            vals, ids = top_extents(ext_masked,
                                    min(budget, ext_masked.shape[0]))
            lattice_pass(tris[ids], tri_color[ids], vals > 0.0, subdiv)

    # --- particles ---------------------------------------------------------
    px, py, d, front = project(mvp, positions, w, h)
    pcol = _f32(cfg.particle_render_color, device).expand(
        positions.shape[0], 3)
    if particle_radius is None:
        # reference point size: min(base/w, max) px on a 1400px viewport,
        # interpreted as the sprite diameter (frag discards outside the
        # radius-0.5 point coord circle, render.frag:20-26)
        size_px = torch.clamp(
            torch.full_like(d, cfg.particle_render_size)
            / torch.clamp(d, min=1e-6),
            max=cfg.particle_render_max_size)
        r_px = torch.clamp(0.5 * size_px * (min(w, h) / REFERENCE_VIEWPORT),
                           0.0, float(max_sprite_radius))
        rmax = max_sprite_radius
    else:
        r_px = torch.full_like(d, float(particle_radius))
        rmax = particle_radius
    r = torch.clamp(r_px, min=0.5)      # center pixel always lit
    r2 = r * r
    for dx in range(-rmax, rmax + 1):
        for dy in range(-rmax, rmax + 1):
            if dx * dx + dy * dy > rmax * rmax:
                continue  # never inside any sprite's circle
            if dx == 0 and dy == 0:
                passes.append((px, py, d, active & front, pcol))
                continue
            lit = (dx * dx + dy * dy) <= r2
            passes.append((px + dx, py + dy, d, active & front & lit, pcol))

    for (ppx, ppy, pd, pv, _) in passes:
        depth = splat_depth(depth, ppx, ppy, pd, pv, w, h)
    for (ppx, ppy, pd, pv, pc) in passes:
        color = splat_color(color, depth, ppx, ppy, pd, pc, pv, w, h)

    bg = torch.as_tensor(
        (np.asarray(cfg.background_color) * 255).astype(np.uint8),
        device=device)
    rgb = torch.stack([(color >> 16) & 0xFF, (color >> 8) & 0xFF,
                       color & 0xFF], dim=-1).to(torch.uint8)
    hit = ((color >> 30) & 1) == 1
    img = torch.where(hit[:, None], rgb, bg[None, :])
    return img.reshape(h, w, 3)


# The JAX package's public entry point is the jitted whole-frame render; the
# port has no compiled variant, and the name stays for callers that look
# for it.
render_particles_and_surface_jit = render_particles_and_surface
