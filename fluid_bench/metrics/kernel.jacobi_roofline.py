"""K2's share of its roofline: the bound of one step's solve at the
configuration's shapes (`fluid_bench/kernels/jacobi.py`) over K2's device
ms a step in the traced stretch."""


def read(run):
    return run.roofline_pct("jacobi")
