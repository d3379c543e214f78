"""Cell type codes, value-for-value those of `tpu_fluid.core.types`, since
the codes appear in persisted state and in the tests that hold the two
packages against each other."""


class CellType:
    INACTIVE = 0  # out-of-fluid, untouched cell
    AIR = 1       # empty cell bordering water
    WATER = 2     # cell containing >=1 marker particle
    SOLID = 3     # domain boundary / obstacle
