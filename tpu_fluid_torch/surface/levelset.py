"""Level-set surface field (`tpu_fluid.surface.levelset`), a
beyond-reference option: `FluidConfig.surface_method = "levelset"`.

The field is rebuilt from the particles every frame, on the detailed grid:

  1. phi = chamfer distance (detailed cells) to the nearest occupied cell:
     0 where occupied, else _BIG, then `sweeps` min-plus passes over the
     26-neighbourhood with weights 1, sqrt 2 and sqrt 3;
  2. f = iso - min(phi, sweeps + 1): positive inside, zero `iso` cells
     out, the sign convention of the stage-17 field;
  3. `smooth` 7-point box-blur passes; cells under a SOLID sim cell keep
     their value, as in stage 18.

The JAX package computes this in XLA, with no Pallas kernel, so here it is
plain torch, each min taken in `_CHAMFER26` order and each sum in MOVES
order as JAX takes them.

Where `kernel_choice` picks it, the field is one hand-written march over
the boxes that water reaches (`kernels/levelset.py`, bitwise this
function), which writes f1 and f2 at once and raises for a configuration
it cannot take.  Elsewhere it runs as the plain passes of
`levelset_plain`.

With tracing on (`utils/profiling`) the field is the span `levelset` and
counts the detailed cells it is given (`levelset.cells`; on the x-slab
step the extended slab) and, on the device, those whose distance ends at
most `sweeps` (`levelset.band_cells`, the band the sweeps reach).  Inside
it, the plain passes are the spans `levelset.chamfer` and
`levelset.smooth`; the kernel's launches the spans `levelset.scan` and
`levelset.march`, with the counters `levelset.live_boxes` (on the device)
and `levelset.boxes`.  With tracing off it launches nothing more.
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.kernels import kernel_choice, store
from tpu_fluid_torch.kernels import levelset as kernel
from tpu_fluid_torch.ops.stencil import MOVES, div_const, shifted
from tpu_fluid_torch.stages.surface_fields import solid_parent_mask
from tpu_fluid_torch.utils import profiling

_BIG = 1e6

# 26-neighbourhood offsets with quasi-Euclidean chamfer weights (1, sqrt 2,
# sqrt 3 for face, edge and corner steps)
_CHAMFER26 = tuple(
    ((dx, dy, dz), float((dx * dx + dy * dy + dz * dz) ** 0.5))
    for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    if (dx, dy, dz) != (0, 0, 0))


def chamfer_distance(occ: torch.Tensor, sweeps: int,
                     metric: str = "euclid26") -> torch.Tensor:
    """f32 distance (cells) to the nearest occupied cell, exact up to
    `sweeps` steps, _BIG beyond the band.  "euclid26" is the 26-neighbour
    quasi-Euclidean chamfer, "manhattan6" the 6-neighbour metric.  The
    fills are made on the device, so a CUDA graph can capture it."""
    phi = torch.full(occ.shape, _BIG, dtype=torch.float32, device=occ.device)
    phi.masked_fill_(occ != 0, 0.0)
    if metric == "manhattan6":
        for _ in range(sweeps):
            nb = torch.full_like(phi, _BIG)
            for mv in MOVES:
                torch.minimum(nb, shifted(phi, mv, fill=_BIG), out=nb)
            phi = torch.minimum(phi, nb + 1.0)
        return phi
    if metric != "euclid26":
        raise ValueError(f"unknown chamfer metric {metric!r}")
    for _ in range(sweeps):
        nb = phi.clone()
        for mv, w in _CHAMFER26:
            s = shifted(phi, mv, fill=_BIG)
            torch.minimum(nb, s.add_(w), out=nb)
        phi = nb
    return phi


def band_cells(phi: torch.Tensor, sweeps: int) -> torch.Tensor:
    """The cells whose chamfer distance is at most `sweeps`, as a device
    scalar: the occupied cells and the band the sweeps reached."""
    return (phi <= sweeps).sum()


def levelset_fields(types: torch.Tensor, occ: torch.Tensor,
                    cfg: FluidConfig, out=(None, None)) -> tuple:
    """(sim types, detailed occupancy) -> (f1, f2), the signed field on
    the detailed grid: positive inside, its 0-isosurface `levelset_iso`
    cells outside the particles; written into `out`'s two tensors where
    given, else one tensor for both.  The kernel writes both tensors; the
    plain passes write f1 and copy it into f2, after the span."""
    f1_to, f2_to = out
    with profiling.span("levelset"):
        profiling.count("levelset.cells", occ.numel())
        if kernel_choice(cfg, occ.device):
            return kernel.levelset_cuda(types, occ, cfg, out=out)
        f = levelset_plain(types, occ, cfg, out=f1_to)
    return f, store(f, f2_to)


def levelset_plain(types: torch.Tensor, occ: torch.Tensor,
                   cfg: FluidConfig, out: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """The field as plain passes, written into `out` where given (by the
    last smoothing pass, where there is one)."""
    sweeps = cfg.levelset_sweeps_value
    with profiling.span("levelset.chamfer"):
        phi = chamfer_distance(occ, sweeps)
    if profiling.enabled():
        profiling.count_on_device("levelset.band_cells",
                                  band_cells(phi, sweeps))
    f = cfg.levelset_iso_value - torch.clamp(phi, max=sweeps + 1.0)
    if not cfg.levelset_smooth:
        return store(f, out)
    with profiling.span("levelset.smooth"):
        skip = solid_parent_mask(types, cfg)
        for k in range(cfg.levelset_smooth):
            nsum = torch.zeros_like(f)
            for mv in MOVES:
                nsum.add_(shifted(f, mv, fill=0.0))
            last = k == cfg.levelset_smooth - 1
            f = torch.where(skip, f, div_const(f + nsum, 7.0),
                            out=out if last else None)
    return f
