"""K5, the surface fields (stages 16-18) on the detailed grid: its
kernels' names in the trace, and the bound of one step's call from the
configuration.

It reads the u8 occupancy, the inertia, the stale f32 blur buffer and the
u8 skip mask, and writes the inertia and both f32 blur buffers: 16 bytes
a cell with u8 inertia (24 with int32).  It does 4 float32 operations a
cell for the signed field and 8 a blur pass."""

from fluid_bench.kernels.peaks import bound_ms

NAMES = ("surface_march_kernel",)


def bound(fields: dict) -> tuple:
    r = fields["surface_render_resolution"]
    cells = 1
    for g in fields["grid_size"]:
        cells *= g * r
    inertia = 1 if 0 < fields["max_inertia"] <= 255 else 4
    moved = cells * (1 + inertia + 4 + 1 + inertia + 4 + 4)
    ops = cells * (4 + 8 * fields["float_density_diffuse_steps"])
    return bound_ms(moved, ops)
