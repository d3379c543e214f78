"""K2, the pressure solve's Jacobi sweeps (stage 12): its kernels' names in
the trace, and the bound of one step's solve from the configuration.

A sweep does 7 float32 operations a cell (five adds of the neighbours, a
multiply by the reciprocal diagonal, the add of the constant), and the
program runs jacobi_iters - 1 sweeps (the reference's projection reads its
199th of 200 iterates).  It reads the start pressure (f32), the u8
diagonal code and the f32 constant, and writes the pressure: 13 bytes a
cell."""

from fluid_bench.kernels.peaks import bound_ms

NAMES = ("jacobi_whole_kernel", "jacobi_march_kernel")


def bound(fields: dict) -> tuple:
    gx, gy, gz = fields["grid_size"]
    cells = gx * gy * gz
    sweeps = fields["jacobi_iters"] - (
        1 if fields["reference_pressure_parity"] else 0)
    return bound_ms(13 * cells, 7 * cells * sweeps)
