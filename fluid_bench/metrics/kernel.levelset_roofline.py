"""The level set's share of its roofline: the bound of one step's level
set at the configuration's shapes (`fluid_bench/kernels/levelset.py`)
over the device ms a step of its kernels in the traced stretch.  None
where they did not run: the plain passes, or a cell without the level
set."""


def read(run):
    return run.roofline_pct("levelset")
