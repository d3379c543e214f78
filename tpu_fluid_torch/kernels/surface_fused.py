"""K5: surface-field stages 16-18 on the detailed grid.

Replaces `tpu_fluid/kernels/surface_fused.py:surface_fused_pallas`
(kernel `_surface_kernel`, body `_surface_stages`, reached through
`surface_fused_auto` for planes up to `MAX_PLANE`); CUDA source
`csrc/surface_fused.cu`.  Stage 16 updates the inertia in int32 and stores
it in its own dtype; stage 17 makes the signed field
f = nzi * (I / div) + (nzi - 1); stage 18 runs `steps` ping-pong blur passes
f' = (1 - 6k) f + k * (x+1, x-1, y+1, y-1, z+1, z-1 neighbours, 0 outside),
where cells under a SOLID parent keep their value.  The TPU kernel fuses
all of it over VMEM x-slabs; here one launch does 16+17 and one launch per
blur pass streams the grid, so the work is bandwidth-bound at about 13
bytes per cell per pass (67 MB per f32 field at 256^3).

K5 also covers `surface_fused_2d` (`surface_fused.py:266`), the (x, y)-tiled
form JAX runs for detailed planes above `MAX_PLANE` (the 512^3 detailed
grid of `scaled_scene(256)`): the same stages and order, cut differently
for VMEM.  K5 has no plane limit; tests/test_torch_kernels.py holds the 2D
form against `surface_fused_plain`.

`surface_fused_plain` is the same function in plain PyTorch, with the
kernel's integer formulation and neighbour order (the XLA stages in
`stages/surface_fields.py` add the neighbours in `MOVES` order).
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.kernels import build, on_cuda, require
from tpu_fluid_torch.ops.stencil import AXIS_MOVES, div_scalar, neighbor_sum

_ARGTYPES = ((build.POINTER,) * 7 + (build.INT,) * 5
             + (build.FLOAT, build.FLOAT) + (build.INT,) * 5
             + (build.FLOAT, build.POINTER))


def _blur_constants(k: float) -> tuple[float, float]:
    """(1 - 6k, k), computed in double as the JAX kernel's Python floats
    are, and rounded to f32 where they meet the field."""
    return 1.0 - 6.0 * k, k


def surface_fused_plain(occ, inertia, f2, skip, *, steps, k, inc_filled,
                        inc_neigh, required_hits, dec, max_inertia,
                        div_coef):
    filled = torch.clamp(occ.to(torch.int32), max=1)
    hits = neighbor_sum(filled, moves=AXIS_MOVES)
    ge = torch.clamp(hits - (required_hits - 1), 0, 1)
    inc = filled * inc_filled + ge * hits * inc_neigh
    nz = torch.clamp(inc, 0, 1)
    old = inertia.to(torch.int32)
    increased = old + inc
    decreased = torch.clamp(old - dec, min=0)
    new = torch.clamp(decreased + nz * (increased - decreased),
                      max=max_inertia)
    nzi = torch.clamp(new, 0, 1).to(torch.float32)
    a = nzi * div_scalar(new.to(torch.float32), div_coef) + (nzi - 1.0)
    b = f2
    c0, c1 = _blur_constants(k)
    keep = skip != 0
    for it in range(steps):
        src, dst = (a, b) if it % 2 == 0 else (b, a)
        blurred = c0 * src + c1 * neighbor_sum(src, moves=AXIS_MOVES)
        res = torch.where(keep, dst, blurred)
        if it % 2 == 0:
            b = res
        else:
            a = res
    return new.to(inertia.dtype), a, b


def surface_fused_cuda(occ, inertia, f2, skip, *, steps, k, inc_filled,
                       inc_neigh, required_hits, dec, max_inertia,
                       div_coef):
    """K5 wrapper: occ u8, inertia u8 or int32, f2 f32 (the stale buffer)
    and skip u8, all (D,D,D) -> (inertia', f1', f2'); the CUDA kernels for
    CUDA tensors, `surface_fused_plain` for CPU tensors."""
    require(occ, "occ", torch.uint8)
    if occ.ndim != 3:
        raise ValueError(f"occ: shape {tuple(occ.shape)}, expected (X,Y,Z)")
    require(inertia, "inertia", (torch.uint8, torch.int32), occ.shape,
            occ.device)
    require(f2, "f2", torch.float32, occ.shape, occ.device)
    require(skip, "skip", torch.uint8, occ.shape, occ.device)
    kw = dict(steps=steps, k=k, inc_filled=inc_filled, inc_neigh=inc_neigh,
              required_hits=required_hits, dec=dec, max_inertia=max_inertia,
              div_coef=div_coef)
    if not on_cuda(occ):
        return surface_fused_plain(occ, inertia, f2, skip, **kw)
    inertia_out = torch.empty_like(inertia)
    f1_out = torch.empty_like(f2)
    f2_out = torch.empty_like(f2)
    gx, gy, gz = occ.shape
    c0, c1 = _blur_constants(k)
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        build.call("tf_surface_fused", _ARGTYPES, occ.data_ptr(),
                   inertia.data_ptr(), inertia_out.data_ptr(),
                   f2.data_ptr(), skip.data_ptr(), f1_out.data_ptr(),
                   f2_out.data_ptr(), inertia.element_size(), gx, gy, gz,
                   steps, c0, c1, inc_filled, inc_neigh, required_hits, dec,
                   max_inertia, div_coef, stream)
    surface_fused_cuda.launches += 1
    return inertia_out, f1_out, f2_out


surface_fused_cuda.launches = 0
