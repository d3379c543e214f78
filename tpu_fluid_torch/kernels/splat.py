"""The facade's splat: particle sprites and surface-lattice samples drawn
into an (H, W, 3) uint8 image by z-buffer, in one CUDA kernel pair.

Replaces no Pallas kernel: the JAX package leaves the frame to XLA
scatters inside one jitted frame (`tpu_fluid/render/splat.py:215-223`).
CUDA source `csrc/splat.cu`: a fill, a depth kernel (one thread a
particle, projected once in registers, walking its sprite footprint, and
one thread a lattice sample, generated in registers from its pass's
triangle table: the barycentric point, its projection and its triangle's
shading; atomicMin on the depth's bits), a colour kernel (the same samples
against the finished depth buffer; atomicMax of the winners' packed words)
and a composite pass.  Both reductions are order-independent, so the frame
is the plain version's bit for bit.

`splat_frame_plain` is the plain version, and the only one the frame has:
`render/splat.py`'s sprite passes after the lattice passes
(`lattice_passes`, the plain expansion of the same tables), drawn a pass
at a time by scatter_reduce (`draw_passes`).  `footprint` is the table of
offsets the kernel walks, the plain loop's sprite passes in the order of
their distance from the centre.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpu_fluid_torch.kernels import build, on_cuda, require
from tpu_fluid_torch.render.splat import (DEPTH_TOL, INF_DEPTH,
                                          REFERENCE_VIEWPORT, background,
                                          draw_passes, lattice_passes,
                                          light_direction, sprite_passes)
from tpu_fluid_torch.utils import profiling

_ARGTYPES = ((build.POINTER,) * 2 + (build.INT64,) + (build.POINTER,) * 2
             + (build.INT,) + (build.FLOAT,) * 4 + (build.INT,)
             + (build.FLOAT,) * 3 + (build.POINTER,) * 3 + (build.INT,)
             + (build.FLOAT,) * 9 + (build.INT,) * 2 + (build.FLOAT,) * 2
             + (build.INT,) * 3 + (build.POINTER,) * 5)

# lattice passes a frame takes (`surface_tables` gives three; kMaxLattice)
MAX_LATTICE = 3
# the finest lattice whose (S+1)(S+2)/2 samples a slot fit an int
MAX_SUBDIV = 65534

# the counters of the counting instantiation, in the kernel's order
COUNTS = ("depth_tested", "depth_atomics", "color_tested", "color_won",
          "color_atomics", "lattice_samples")


def footprint(particle_radius: int | None = None,
              max_sprite_radius: int = 3) -> tuple:
    """The sprite offsets (dx, dy) the kernel walks: dx^2 + dy^2 <= rmax^2
    for rmax the fixed `particle_radius`, else `max_sprite_radius`; the
    centre first and nearer before farther (the plain loop's order among
    equal distances), so the walk stops at the first one outside a
    sprite."""
    rmax = max_sprite_radius if particle_radius is None else particle_radius
    offsets = [(dx, dy) for dx in range(-rmax, rmax + 1)
               for dy in range(-rmax, rmax + 1)
               if dx * dx + dy * dy <= rmax * rmax]
    return tuple(sorted(offsets, key=lambda o: o[0] * o[0] + o[1] * o[1]))


@functools.lru_cache(maxsize=None)
def _offsets(particle_radius, max_sprite_radius,
             device: torch.device) -> torch.Tensor:
    return torch.tensor(footprint(particle_radius, max_sprite_radius),
                        dtype=torch.int32, device=device).reshape(-1, 2)


def splat_frame_plain(positions, active, mvp, lattice, cfg, width, height, *,
                      particle_radius=None,
                      max_sprite_radius=3) -> torch.Tensor:
    """The frame in plain PyTorch: the lattice passes, then the sprite
    passes, one scatter-min and one scatter-max a pass."""
    with profiling.span("splat.sprites"):
        passes = list(lattice) + sprite_passes(
            positions, active, mvp, cfg, width, height, particle_radius,
            max_sprite_radius)
    with profiling.span("splat.scatter"):
        return draw_passes(passes, width, height, cfg, positions.device)


def _check_surface(tris, normals, tables, device) -> None:
    if tris is None:
        if normals is not None or tables:
            raise ValueError("tris None: no normals and no lattice tables")
        return
    require(tris, "tris", torch.float32, device=device)
    if tris.ndim != 3 or tuple(tris.shape[1:]) != (3, 3):
        raise ValueError(f"tris: shape {tuple(tris.shape)}, expected "
                         f"(T,3,3)")
    n_tris = tris.shape[0]
    require(normals, "normals", torch.float32, (n_tris, 3), device)
    if len(tables) > MAX_LATTICE:
        raise ValueError(f"lattice: {len(tables)} tables, at most "
                         f"{MAX_LATTICE}")
    for k, (ids, valid, subdiv) in enumerate(tables):
        require(valid, f"lattice[{k}] valid", torch.bool, device=device)
        if valid.ndim != 1:
            raise ValueError(f"lattice[{k}] valid: shape "
                             f"{tuple(valid.shape)}, expected (slots,)")
        if ids is None:
            if valid.shape[0] != n_tris:
                raise ValueError(f"lattice[{k}] valid: {valid.shape[0]} "
                                 f"slots without ids, expected {n_tris}")
        else:
            require(ids, f"lattice[{k}] ids", torch.int64, valid.shape,
                    device)
        if not (isinstance(subdiv, int) and 1 <= subdiv <= MAX_SUBDIV):
            raise ValueError(f"lattice[{k}] subdiv {subdiv!r}, expected an "
                             f"int in [1, {MAX_SUBDIV}]")


def splat_frame_cuda(positions: torch.Tensor, active: torch.Tensor,
                     mvp: torch.Tensor, tris: torch.Tensor | None,
                     normals: torch.Tensor | None, tables, cfg, width: int,
                     height: int, *, particle_radius: int | None = None,
                     max_sprite_radius: int = 3,
                     counts: torch.Tensor | None = None) -> torch.Tensor:
    """The frame of `render_particles_and_surface`: positions (P, 3) f32,
    active (P,) bool, mvp (4, 4) f32, the mesh's tris (T, 3, 3) and normals
    (T, 3) f32 (both None: no surface), and `tables`, the lattice passes of
    `render.splat.surface_tables` (ids (n,) int64 of triangles in [0, T) or
    None for every slot, valid (n,) bool, subdiv), a list of at most
    `MAX_LATTICE`, maybe empty -> (height, width, 3) uint8.  Sprites as
    `sprite_passes` sizes them; `cfg` gives their size and colour, the
    surface's shading and the background.  The CUDA kernels for CUDA
    tensors, which sample each lattice in registers; for CPU tensors
    `lattice_passes` and `splat_frame_plain`.  `counts`, a zeroed (6,)
    int64 tensor on the card, runs the counting instantiation instead,
    which adds `COUNTS` into it.
    """
    require(positions, "positions", torch.float32)
    if positions.ndim != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions: shape {tuple(positions.shape)}, "
                         f"expected (P,3)")
    device = positions.device
    require(active, "active", torch.bool, (positions.shape[0],), device)
    require(mvp, "mvp", torch.float32, (4, 4), device)
    if not (isinstance(width, int) and isinstance(height, int)
            and width >= 1 and height >= 1):
        raise ValueError(f"viewport {width!r} x {height!r}, expected ints "
                         f">= 1")
    tables = list(tables)
    _check_surface(tris, normals, tables, device)
    if not on_cuda(positions):
        if counts is not None:
            raise ValueError("counts: the counting kernels need CUDA tensors")
        lattice = ([] if tris is None else lattice_passes(
            tris, normals, tables, mvp, cfg, width, height))
        return splat_frame_plain(positions, active, mvp, lattice, cfg, width,
                                 height, particle_radius=particle_radius,
                                 max_sprite_radius=max_sprite_radius)
    if counts is not None:
        require(counts, "counts", torch.int64, (len(COUNTS),), device)
    scaled = particle_radius is None
    offsets = _offsets(particle_radius, max_sprite_radius, device)
    # a row a lattice pass: its ids (0: every slot) and validity pointers,
    # its slots, its subdiv
    table = (ctypes.c_longlong * (4 * MAX_LATTICE))(*(
        v for ids, valid, subdiv in tables
        for v in (0 if ids is None else ids.data_ptr(), valid.data_ptr(),
                  valid.shape[0], subdiv)))
    color = np.asarray(cfg.particle_render_color, np.float32)
    # the shading's constants by value, rounded to float as the plain
    # version's tensors hold them
    shading = np.concatenate([
        light_direction(cfg),
        np.asarray(cfg.render_surface_ambient_color, np.float32),
        np.asarray(cfg.render_surface_diffuse_color, np.float32)])
    bg = background(cfg)
    n = width * height
    depth = torch.empty(n, dtype=torch.int32, device=device)
    packed = torch.empty(n, dtype=torch.int32, device=device)
    image = torch.empty((height, width, 3), dtype=torch.uint8, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.call(
            "tf_splat", _ARGTYPES, positions.data_ptr(), active.data_ptr(),
            positions.shape[0], mvp.data_ptr(), offsets.data_ptr(),
            offsets.shape[0], float(cfg.particle_render_size),
            float(cfg.particle_render_max_size),
            # PyTorch's tensor-scalar products take the scalar in f32
            float(np.float32(min(width, height) / REFERENCE_VIEWPORT)),
            float(max_sprite_radius if scaled else particle_radius),
            int(scaled), *(float(c) for c in color), ptr(tris), ptr(normals),
            ctypes.addressof(table), len(tables),
            *(float(c) for c in shading), width, height,
            float(np.float32(1 + DEPTH_TOL)), INF_DEPTH, *(int(c) for c in bg),
            depth.data_ptr(), packed.data_ptr(), image.data_ptr(),
            ptr(counts), stream)
    splat_frame_cuda.launches += 1
    return image


splat_frame_cuda.launches = 0
