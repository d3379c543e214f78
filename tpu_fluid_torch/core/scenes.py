"""Scene presets (`tpu_fluid.core.scenes`), copied.

The reference hardcodes one scene (particle slab and center-floor fountain
in a solid 20^3 box, `simulation_constants.h:48-87`); every preset here is
a FluidConfig, so scenes are data, not code.  Arbitrary solids and force
fields go beside the state as `core/scene_fields.SceneFields`.
"""

from __future__ import annotations

from tpu_fluid_torch.core.config import FluidConfig


def fountain(n: int = 20, particle_count: int = 1_000_000) -> FluidConfig:
    """The reference scene (optionally scaled)."""
    if n == 20:
        return FluidConfig.reference_scene().replace(
            particle_count=particle_count)
    return FluidConfig.scaled_scene(n, particle_count=particle_count)


def dam_break(n: int = 20, particle_count: int = 1_000_000) -> FluidConfig:
    """Classic dam break: a tall water column in one corner, no fountain."""
    s = n / 20.0
    res = max(1, round(particle_count ** (1 / 3)))
    return FluidConfig(
        grid_size=(n, n, n),
        particle_count=particle_count,
        particle_init_cube_resolution=(res, res, res),
        particle_init_cube_offset=(1.5 * s, 1.5 * s, 1.5 * s),
        particle_init_cube_size=(6.0 * s, 14.0 * s, 17.0 * s),
        fountain_force=0.0,
        surface_render_resolution=5 if n <= 32 else 2,
    )


def drop(n: int = 20, particle_count: int = 1_000_000) -> FluidConfig:
    """A compact cube dropped into a shallow pool (no fountain).

    Two particle bodies: the falling cube (primary) and a shallow pool
    covering the floor (extra cube); budgets roughly half the particles to
    each.  +y is down (SURVEY.md §2.4#08), so the floor is at high y.
    """
    s = n / 20.0
    res = max(1, round((particle_count // 2) ** (1 / 3)))
    # pool: a wide flat slab resting on the floor (wall at y = n-1)
    pool_size = (17.0 * s, 2.5 * s, 17.0 * s)
    pool_vol = pool_size[0] * pool_size[1] * pool_size[2]
    k = max(1.0, (particle_count / 2 / pool_vol)) ** (1 / 3)
    pool_res = tuple(max(1, int(d * k)) for d in pool_size)
    return FluidConfig(
        grid_size=(n, n, n),
        particle_count=particle_count,
        particle_init_cube_resolution=(res, res, res),
        particle_init_cube_offset=(7.0 * s, 3.0 * s, 7.0 * s),
        particle_init_cube_size=(6.0 * s, 6.0 * s, 6.0 * s),
        extra_particle_cubes=(
            (pool_res, (1.5 * s, (20.0 - 1.0 - 2.5) * s, 1.5 * s),
             pool_size),),
        fountain_force=0.0,
        surface_render_resolution=5 if n <= 32 else 2,
    )


def dam_break_obstacle(n: int = 20,
                       particle_count: int = 1_000_000) -> FluidConfig:
    """Dam break against a solid pillar mid-domain (exercises solid_boxes,
    the generalization of the reference's commented-out ramp obstacle,
    `update_active.comp:50`)."""
    cfg = dam_break(n, particle_count)
    s = n / 20.0

    def c(v):     # cell index, clamped inside the walls
        return max(1, min(n - 1, round(v * s)))

    return cfg.replace(solid_boxes=(
        ((c(10), c(12), c(7)), (c(12), c(19), c(13))),))


SCENES = {"fountain": fountain, "dam_break": dam_break, "drop": drop,
          "dam_break_obstacle": dam_break_obstacle}
