"""Surface-field stages: density inertia (16), signed float field (17),
float-density blur (18) (`tpu_fluid.stages.surface_fields`)."""

from __future__ import annotations

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.kernels import kernel_choice
from tpu_fluid_torch.kernels.surface_fused import (surface_fused_cuda,
                                                   surface_fused_plain)
from tpu_fluid_torch.ops.stencil import MOVES, div_scalar, shifted


def update_inertia(detailed_densities: torch.Tensor, inertia: torch.Tensor,
                   cfg: FluidConfig) -> torch.Tensor:
    """Stage 16 (`densities_inertia.comp:30-62`): += 4 if filled, += hits
    if enough neighbours are filled, else decay by 1 toward 0; clamp to
    max_inertia.  Computes in int32 whatever the storage dtype."""
    filled = detailed_densities > 0
    dtype = inertia.dtype
    inertia = inertia.to(torch.int32)
    inc = torch.where(filled, cfg.inertia_increase_filled, 0).to(torch.int32)
    hits = torch.zeros(inertia.shape, dtype=torch.int32,
                       device=inertia.device)
    for mv in MOVES:
        hits = hits + shifted(filled, mv, fill=False)
    inc = inc + torch.where(hits >= cfg.inertia_required_neighbour_hits,
                            hits * cfg.inertia_increase_neighbour, 0)
    increased = inertia + inc
    decreased = torch.clamp(inertia - cfg.inertia_decrease, min=0)
    new = torch.where(inc == 0, decreased, increased)
    return torch.clamp(new, max=cfg.max_inertia).to(dtype)


def float_densities(inertia: torch.Tensor, cfg: FluidConfig) -> torch.Tensor:
    """Stage 17: -1 where inertia == 0, else inertia / division_coefficient."""
    pos = div_scalar(inertia.to(torch.float32),
                     cfg.float_density_division_coefficient)
    return torch.where(inertia == 0, -1.0, pos)


def solid_parent_mask(types: torch.Tensor, cfg: FluidConfig) -> torch.Tensor:
    """Detailed-grid mask of cells whose parent sim cell is SOLID
    (`diffuse_densities.comp:57`)."""
    solid = types == CellType.SOLID
    r = cfg.surface_render_resolution
    for ax in range(3):
        solid = torch.repeat_interleave(solid, r, dim=ax)
    return solid


def blur_float_densities(types: torch.Tensor, f1: torch.Tensor,
                         f2: torch.Tensor, cfg: FluidConfig):
    """Stage 18: f' = (1-6k) f + k * sum of neighbours (MOVES order),
    ping-ponged `float_density_diffuse_steps` times; cells under a SOLID
    parent keep their stale value.  Returns (f1, f2)."""
    k = cfg.float_density_diffuse_coefficient
    skip = solid_parent_mask(types, cfg)

    def one_pass(src, dst):
        nsum = torch.zeros_like(src)
        for mv in MOVES:
            nsum = nsum + shifted(src, mv)
        blurred = (1.0 - 6.0 * k) * src + k * nsum
        return torch.where(skip, dst, blurred)

    for it in range(cfg.float_density_diffuse_steps):
        if it % 2 == 0:
            f2 = one_pass(f1, f2)
        else:
            f1 = one_pass(f2, f1)
    return f1, f2


def update_surface_fields(types: torch.Tensor, occ: torch.Tensor,
                          inertia: torch.Tensor, f2: torch.Tensor,
                          cfg: FluidConfig, out=None):
    """Stages 16-18: (types, occupancy, inertia, stale f2) -> (inertia',
    f1', f2') through the K5 route: the CUDA kernels where `kernel_choice`
    picks them, else their plain version; written into `out`'s three
    tensors where given.  With `surface_method = "levelset"` the field is
    the rebuilt level set instead (`surface/levelset.py`), the same tensor
    for f1 and f2 (with `out`, written into f1's and f2's: by the kernel
    at once, or into f1's and copied into f2's), and the inertia is
    carried through."""
    if cfg.surface_method == "levelset":
        from tpu_fluid_torch.surface.levelset import levelset_fields
        _, f1_to, f2_to = (None, None, None) if out is None else out
        return (inertia,) + levelset_fields(types, occ, cfg,
                                            out=(f1_to, f2_to))
    if cfg.surface_method != "inertia":
        raise ValueError(f"unknown surface_method {cfg.surface_method!r}")
    skip = solid_parent_mask(types, cfg).to(torch.uint8)
    fused = (surface_fused_cuda if kernel_choice(cfg, occ.device)
             else surface_fused_plain)
    return fused(
        occ, inertia, f2, skip, out=out,
        steps=cfg.float_density_diffuse_steps,
        k=cfg.float_density_diffuse_coefficient,
        inc_filled=cfg.inertia_increase_filled,
        inc_neigh=cfg.inertia_increase_neighbour,
        required_hits=cfg.inertia_required_neighbour_hits,
        dec=cfg.inertia_decrease,
        max_inertia=cfg.max_inertia,
        div_coef=cfg.float_density_division_coefficient)


def surface_field(state_f1: torch.Tensor, state_f2: torch.Tensor,
                  cfg: FluidConfig) -> torch.Tensor:
    """The field the renderer consumes: the n-th blur pass lands in f2 for
    odd n and in f1 for even n."""
    if cfg.float_density_diffuse_steps % 2 == 1:
        return state_f2
    return state_f1
