"""Host-side frame rendering through the native C++ rasterizer
(`tpu_fluid.render.raster`).

Exact-parity counterpart of the reference's raster pipelines: depth-tested
point sprites sized min(base/depth, max) drawn as circles
(`30_render_particles`), and flat Lambert-shaded marching-cubes triangles
(`31_render_surface`).  The inputs are host numpy arrays; the library
builds with g++ at first use (`tpu_fluid_torch.native`) and raises if it
cannot.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.native import load_rasterizer


def shade_triangles(normals: np.ndarray, cfg: FluidConfig) -> np.ndarray:
    """Flat shading: ambient + max(0, dot(-L, N)) * diffuse
    (`render_surface.frag:21-26`)."""
    light = np.asarray(cfg.render_light_direction, dtype=np.float32)
    light = light / np.linalg.norm(light)
    lam = np.maximum(0.0, -(normals @ light))
    amb = np.asarray(cfg.render_surface_ambient_color, dtype=np.float32)
    dif = np.asarray(cfg.render_surface_diffuse_color, dtype=np.float32)
    return amb[None, :] + lam[:, None] * dif[None, :]


def render_frame_native(positions, active, tris, normals, mvp,
                        cfg: FluidConfig, width: int = 1024,
                        height: int = 1024) -> np.ndarray:
    """positions (P,3), active (P,), tris (T,3,3), normals (T,3) — all host
    numpy, any of them None.  Returns (H, W, 3) uint8."""
    lib = load_rasterizer()

    depth = np.empty(width * height, dtype=np.float32)
    rgb = np.empty(width * height * 3, dtype=np.uint8)
    bg = (np.asarray(cfg.background_color) * 255).astype(np.uint8)
    lib.clear_buffers(depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      width * height, bg[0], bg[1], bg[2])

    mvp32 = np.ascontiguousarray(mvp, dtype=np.float32).reshape(16)
    fp = ctypes.POINTER(ctypes.c_float)
    u8 = ctypes.POINTER(ctypes.c_uint8)

    if tris is not None and len(tris):
        t32 = np.ascontiguousarray(tris, dtype=np.float32)
        colors = np.ascontiguousarray(shade_triangles(
            np.asarray(normals, dtype=np.float32), cfg))
        if t32.shape[1:] != (3, 3) or colors.shape != (len(t32), 3):
            raise ValueError(f"tris {t32.shape} and normals "
                             f"{np.shape(normals)} must be (T,3,3), (T,3)")
        lib.rasterize_triangles(
            t32.ctypes.data_as(fp), colors.ctypes.data_as(fp),
            len(t32), mvp32.ctypes.data_as(fp), width, height,
            depth.ctypes.data_as(fp), rgb.ctypes.data_as(u8))

    if positions is not None and len(positions):
        p32 = np.ascontiguousarray(positions, dtype=np.float32)
        a8 = np.ascontiguousarray(active, dtype=np.uint8)
        if p32.shape[1:] != (3,) or a8.shape != (len(p32),):
            raise ValueError(f"positions {p32.shape} and active {a8.shape} "
                             f"must be (P,3), (P,)")
        col = cfg.particle_render_color
        lib.rasterize_points(
            p32.ctypes.data_as(fp), a8.ctypes.data_as(u8), len(p32),
            mvp32.ctypes.data_as(fp),
            cfg.particle_render_size, cfg.particle_render_max_size,
            col[0], col[1], col[2], width, height,
            depth.ctypes.data_as(fp), rgb.ctypes.data_as(u8))

    return rgb.reshape(height, width, 3)
