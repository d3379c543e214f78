"""Simulation configuration, field for field the JAX package's
`tpu_fluid.core.config.FluidConfig`, so that config JSON (checkpoints, CLI
overrides) stays interchangeable between the two packages.

Only the dtype properties differ: `torch_dtype` takes the place of
`jnp_dtype`, and `inertia_dtype` names a torch dtype.  `pallas_mode` keeps
its name and values and is the port's kernel gate (`kernels.kernel_choice`):
"auto" runs the CUDA kernels on CUDA tensors and their plain PyTorch
versions on CPU tensors, "off" and "interpret" run the plain versions, and
"on" runs the kernels or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def deep_tuple(x):
    """Recursively convert lists to tuples at every nesting level (JSON
    round-trips turn the nested tuples of `solid_boxes` / `extra_forces`
    into lists; the config must stay hashable)."""
    if isinstance(x, (list, tuple)):
        return tuple(deep_tuple(e) for e in x)
    return x


@dataclasses.dataclass(frozen=True)
class FluidConfig:
    # --- grid -------------------------------------------------------------
    grid_size: Tuple[int, int, int] = (20, 20, 20)

    # --- particles ----------------------------------------------------------
    particle_count: int = 1_000_000
    particle_init_cube_resolution: Tuple[int, int, int] = (100, 100, 100)
    particle_init_cube_offset: Tuple[float, float, float] = (5.0, 2.0, 1.5)
    particle_init_cube_size: Tuple[float, float, float] = (10.0, 10.0, 2.0)
    # extra blobs (resolution, offset, size); ids follow the primary cube
    extra_particle_cubes: Tuple[Tuple[Tuple[int, int, int],
                                      Tuple[float, float, float],
                                      Tuple[float, float, float]], ...] = ()

    # --- physics ------------------------------------------------------------
    dt: float = 0.01
    air_pressure: float = 1.0
    cell_width: float = 1.0
    fluid_density: float = 1.0
    gravity: float = 10.0           # +y is down in the reference scene
    diffusion_coefficient: float = 0.01
    jacobi_iters: int = 200
    fountain_position: Tuple[int, int, int] | None = None  # default: derived
    fountain_force: float = -3000.0
    solid_repel_velocity: float = 0.01
    # end-exclusive cell-index AABBs marked SOLID every frame
    solid_boxes: Tuple[Tuple[Tuple[int, int, int],
                             Tuple[int, int, int]], ...] = ()
    # ((cell_x, cell_y, cell_z), (fx, fy, fz)) forces on wet faces
    extra_forces: Tuple[Tuple[Tuple[int, int, int],
                              Tuple[float, float, float]], ...] = ()

    # --- surface (detailed grid) ---------------------------------------------
    surface_render_resolution: int = 5
    max_inertia: int = 100
    inertia_increase_filled: int = 4
    inertia_required_neighbour_hits: int = 1
    inertia_increase_neighbour: int = 1
    inertia_decrease: int = 1
    float_density_division_coefficient: float = 30.0
    float_density_diffuse_coefficient: float = 0.1
    float_density_diffuse_steps: int = 4
    surface_enabled: bool = True

    # --- beyond-reference physics (stages/volume.py, surface/levelset.py) ---
    volume_correction: float = 0.0
    volume_correction_every: int = 1
    volume_drift_max: float = 2.0
    volume_target_density: float | None = None
    volume_jacobi_iters: int = 60
    surface_method: str = "inertia"
    levelset_iso: float | None = None
    levelset_sweeps: int | None = None
    levelset_smooth: int = 2

    # --- faithfulness switches ----------------------------------------------
    reference_diffuse_noop: bool = True
    reference_pressure_parity: bool = True

    # --- rendering ----------------------------------------------------------
    particle_render_color: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    particle_render_size: float = 10.0
    particle_render_max_size: float = 20.0
    render_light_direction: Tuple[float, float, float] = (1.0, -3.0, 1.0)
    render_surface_ambient_color: Tuple[float, float, float] = (0.0, 0.0, 0.3)
    render_surface_diffuse_color: Tuple[float, float, float] = (0.0, 0.8, 0.7)
    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    # --- numerics / performance ----------------------------------------------
    dtype: str = "float32"
    advect_max_displacement: int = 2
    advect_method: str = "auto"      # "auto" | "pallas" | "shift" | "gather"
    particle_sampler: str = "packed"      # "packed" | "gather"
    packed_pair_z: bool = True            # TPU table layout; no effect here
    pallas_mode: str = "auto"        # "auto" | "on" | "interpret" | "off"
    pressure_solver: str = "jacobi"       # "jacobi" | "redblack"
    grid_fused: bool = False              # fused grid kernels (K6)
    particle_sharding: str = "index"
    particle_slot_slack: float = 1.5
    particle_migrate_frac: float = 0.25

    # ---------------------------------------------------------------- derived
    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def fountain(self) -> Tuple[int, int, int]:
        if self.fountain_position is not None:
            return self.fountain_position
        w, h, d = self.grid_size
        return (w // 2, h - 2, d // 2)

    @property
    def volume_target_density_value(self) -> float:
        if self.volume_target_density is not None:
            return float(self.volume_target_density)
        cubes = ((self.particle_init_cube_resolution,
                  self.particle_init_cube_size),) + tuple(
            (res, size) for res, _off, size in self.extra_particle_cubes)
        active = 0
        vol = 0.0
        for res, size in cubes:
            active += res[0] * res[1] * res[2]
            vol += size[0] * size[1] * size[2]
        active = min(active, self.particle_count)
        return float(active) / max(vol, 1e-6)

    @property
    def levelset_iso_value(self) -> float:
        if self.levelset_iso is not None:
            return float(self.levelset_iso)
        spacing = (self.surface_render_resolution
                   / max(self.volume_target_density_value, 1e-6) ** (1 / 3))
        return max(0.8, 1.2 * spacing)

    @property
    def levelset_sweeps_value(self) -> int:
        if self.levelset_sweeps is not None:
            return int(self.levelset_sweeps)
        return int(-(-self.levelset_iso_value // 1)) + 2

    @property
    def detailed_size(self) -> Tuple[int, int, int]:
        r = self.surface_render_resolution
        return tuple(s * r for s in self.grid_size)

    @property
    def inertia_dtype(self) -> torch.dtype:
        """Storage dtype of the detailed inertia field: values are clamped to
        [0, max_inertia] every step, so uint8 holds them exactly whenever
        max_inertia <= 255; all arithmetic runs in int32 either way."""
        return torch.uint8 if 0 < self.max_inertia <= 255 else torch.int32

    @property
    def surface_cells(self) -> Tuple[int, int, int]:
        return tuple(s - 1 for s in self.detailed_size)

    def replace(self, **kw) -> "FluidConfig":
        return dataclasses.replace(self, **kw)

    # -------------------------------------------------------------- factories
    @staticmethod
    def reference_scene() -> "FluidConfig":
        """The reference scene: 20^3 box, 1M-particle slab, center-floor
        fountain."""
        return FluidConfig()

    @staticmethod
    def scaled_scene(n: int,
                     particle_count: int = 1_000_000,
                     surface_render_resolution: int = 2,
                     jacobi_iters: int = 200) -> "FluidConfig":
        """Reference scene geometry scaled to an n^3 grid (offsets and sizes
        scale with n/20)."""
        s = n / 20.0
        res = max(1, round(particle_count ** (1.0 / 3.0)))
        return FluidConfig(
            grid_size=(n, n, n),
            particle_count=particle_count,
            particle_init_cube_resolution=(res, res, res),
            particle_init_cube_offset=(5.0 * s, 2.0 * s, 1.5 * s),
            particle_init_cube_size=(10.0 * s, 10.0 * s, 2.0 * s),
            surface_render_resolution=surface_render_resolution,
            jacobi_iters=jacobi_iters,
            grid_fused=(n >= 256),
        )
