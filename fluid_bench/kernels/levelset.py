"""The level set (`surface/levelset.py`, stages 16-18 under
`surface_method = "levelset"`) as the program's hand-written kernels: the
names of every kernel of its source in the trace (the box scan, the flags
and the march, so that the family's time is the whole level set), and the
bound of one step's level set from the configuration.

Whatever computes the field must read the detailed grid's u8 occupancy
and the u8 sim cell types once, and write the two f32 surface fields (f1
and f2) once: 9 bytes a detailed cell and 1 a sim cell.  The operations
counted are the smoothing's 9 float32 operations a cell a pass (the six
neighbours' adds, the cell's, the product and the select), which never
bound it; the chamfer's, which depend on where the water lies, are not
counted."""

from fluid_bench.kernels.peaks import bound_ms

NAMES = ("levelset_live_scan_kernel", "levelset_live_flag_kernel",
         "levelset_march_kernel")


def bound(fields: dict) -> tuple:
    r = fields["surface_render_resolution"]
    sim = 1
    for g in fields["grid_size"]:
        sim *= g
    cells = sim * r ** 3
    return bound_ms(9 * cells + sim, 9 * cells * fields["levelset_smooth"])
