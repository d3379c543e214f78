"""K5's share of its roofline: the bound of one step's surface stages at
the configuration's shapes (`fluid_bench/kernels/surface.py`) over K5's
device ms a step in the traced stretch."""


def read(run):
    return run.roofline_pct("surface")
