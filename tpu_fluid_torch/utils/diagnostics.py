"""Per-step scalar diagnostics (`tpu_fluid.utils.diagnostics`), computed
on the state's device and read back in one transfer.

The reference has no observability beyond a disabled debug draw pipeline
(SURVEY.md §5.5).  These are the invariants its physics maintains by
construction, surfaced as numbers: post-projection divergence on water
cells, cell-type census, active particle count, velocity CFL number,
inertia bounds.
"""

from __future__ import annotations

from typing import Dict

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.state import FluidState
from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.ops.stencil import div_scalar
from tpu_fluid_torch.stages.pressure import compute_divergence


@torch.no_grad()
def diagnostics(state: FluidState, cfg: FluidConfig) -> Dict[str, float]:
    """Host-side dict of scalars: the 13 values are stacked in f64 on the
    device and read with one `.tolist()` (one device-to-host sync)."""
    t = state.cell_types
    water = t == CellType.WATER
    div = compute_divergence(state.velocity)
    wdiv = torch.where(water, div.abs(), 0.0)
    nwater = water.sum()
    vmax = state.velocity.abs().max()
    pos = state.positions
    act = state.active[:, None]
    inf = torch.tensor(float("inf"), dtype=pos.dtype, device=pos.device)
    values = {
        "step": state.step,
        "particles_active": state.active.sum(),
        "particles_dropped": state.dropped,
        "cells_water": nwater,
        "cells_air": (t == CellType.AIR).sum(),
        "cells_solid": (t == CellType.SOLID).sum(),
        "div_water_max": wdiv.max(),
        "div_water_mean": wdiv.sum() / torch.clamp(nwater, min=1),
        "vel_max": vmax,
        "cfl": div_scalar(vmax * cfg.dt, cfg.cell_width),
        "inertia_max": state.inertia.max(),
        "pos_min": torch.where(act, pos, inf).min(),
        "pos_max": torch.where(act, pos, -inf).max(),
    }
    read = torch.stack([v.to(torch.float64) for v in values.values()])
    return dict(zip(values, read.tolist()))


def format_diagnostics(d: Dict[str, float]) -> str:
    dropped = int(d.get("particles_dropped", 0))
    return (f"step {int(d['step']):6d}  particles {int(d['particles_active'])}"
            + (f" (dropped {dropped})" if dropped else "")
            + f"  water {int(d['cells_water'])}  air {int(d['cells_air'])}"
            f"  |div| mean {d['div_water_mean']:.2e} max {d['div_water_max']:.2e}"
            f"  CFL {d['cfl']:.3f}  pos [{d['pos_min']:.2f},{d['pos_max']:.2f}]")
