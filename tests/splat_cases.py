"""Surfaces for the splat's lattice tests: a marching-cubes sphere and
hand-made triangles, each with a corner case of the lattice selection or
its arithmetic.  Shared by `test_torch_render.py` (the plain route against
JAX) and `test_torch_splat_kernel.py` (the kernel pair against the plain
route on a card); numpy and the port only."""

import numpy as np
import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.render.camera import Camera
from tpu_fluid_torch.surface.marching_cubes import extract_surface

KW = dict(grid_size=(12, 12, 12), surface_render_resolution=2)
CFG = FluidConfig(**KW)
SIZE = (96, 80)


def sphere_mesh():
    """(vertices, normals, valid) of a sphere's marching-cubes mesh, numpy."""
    n = 24
    x, y, z = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    field = (40 - ((x - 11.3) ** 2 + (y - 12.9) ** 2
                   + (z - 10.1) ** 2)).astype(np.float32)
    mesh = extract_surface(torch.from_numpy(field), CFG, 4096)
    return (mesh.vertices.numpy().copy(), mesh.normals.numpy().copy(),
            mesh.valid.numpy().copy())


def _no_valid():
    tris, normals, valid = sphere_mesh()
    return tris, normals, np.zeros_like(valid), Camera.for_scene((12,) * 3), \
        65536


def _all_valid():
    tris, normals, valid = sphere_mesh()
    return tris, normals, np.ones_like(valid), Camera.for_scene((12,) * 3), \
        65536


def _budget_ties():
    # five exact copies of the largest triangle (slots 0, 2, 3, 5, 6) among
    # two smaller ones, budgets 4 and 1: the cut falls among equal extents,
    # where the lower slots go first; the copies' normals differ and the
    # last copy, left out, is the brightest, so the frame shows the order
    big = np.array([[4.0, 4.0, 2.0], [8.0, 4.0, 2.0], [6.0, 8.0, 2.0]],
                   np.float32)
    small = np.array([[5.0, 5.0, 8.0], [7.0, 5.0, 8.0], [6.0, 7.0, 8.0]],
                     np.float32)
    tris = np.stack([big, small, big, big, small + 1.0, big, big])
    normals = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0],
                        [0.0, 0.6, -0.8], [0.0, -0.6, -0.8],
                        [0.0, 0.0, -1.0], [0.6, 0.0, -0.8],
                        [0.0, 1.0, 0.0]], np.float32)
    cam = Camera(position=(6.0, 6.0, -2.0)).look_at_point((6.0, 6.0, 6.0))
    return tris, normals, np.ones(7, bool), cam, 4


def _behind_camera():
    # triangles through the camera's plane: vertices behind it, and some
    # wholly behind
    tris = np.array([
        [[4.0, 5.0, -6.0], [8.0, 5.0, 6.0], [6.0, 8.0, 6.0]],
        [[5.0, 4.0, 8.0], [7.0, 4.0, -5.0], [6.0, 7.0, -5.0]],
        [[3.0, 3.0, -4.0], [9.0, 3.0, -4.0], [6.0, 9.0, -3.0]],
        [[5.0, 5.0, 3.0], [7.0, 5.0, 3.0], [6.0, 7.0, 3.0]]], np.float32)
    normals = np.tile(np.array([[0.0, 0.6, -0.8]], np.float32), (4, 1))
    cam = Camera(position=(6.0, 6.0, -1.0)).look_at_point((6.0, 6.0, 6.0))
    return tris, normals, np.ones(4, bool), cam, 65536


def _nan_normal():
    tris, normals, valid = sphere_mesh()
    live = np.flatnonzero(valid)
    normals[live[::7]] = np.nan
    normals[live[3::7], 1] = np.nan
    return tris, normals, valid, Camera.for_scene((12,) * 3), 65536


def _nonfinite_vertex():
    tris, normals, valid = sphere_mesh()
    live = np.flatnonzero(valid)
    tris[live[::11], 0, 0] = np.nan
    tris[live[5::11], 1, 2] = np.inf
    tris[live[7::11], 2, 1] = -np.inf
    return tris, normals, valid, Camera.for_scene((12,) * 3), 65536


SURFACES = {"no_valid": _no_valid, "all_valid": _all_valid,
            "budget_ties": _budget_ties, "behind_camera": _behind_camera,
            "nan_normal": _nan_normal, "nonfinite_vertex": _nonfinite_vertex}


def particles(n: int = 1500, seed: int = 0):
    """(positions, active) numpy: particles around the scene's middle."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(2, 10, (n, 3)).astype(np.float32),
            rng.random(n) < 0.8)


def surface(name: str):
    """(tris, normals, valid, camera, fine_tri_budget) of a named case, the
    arrays numpy."""
    return SURFACES[name]()
