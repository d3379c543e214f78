"""K5: surface-field stages 16-18 on the detailed grid.

Replaces `tpu_fluid/kernels/surface_fused.py:surface_fused_pallas`
(kernel `_surface_kernel`, body `_surface_stages`, reached through
`surface_fused_auto` for planes up to `MAX_PLANE`); CUDA source
`csrc/surface_fused.cu`.  Stage 16 updates the inertia in int32 and stores
it in its own dtype; stage 17 makes the signed field
f = nzi * (I / div) + (nzi - 1); stage 18 runs `steps` ping-pong blur passes
f' = (1 - 6k) f + k * (x+1, x-1, y+1, y-1, z+1, z-1 neighbours, 0 outside),
where cells under a SOLID parent keep their value.

What bounds it: memory, 16 bytes a cell with u8 inertia (occ, inertia,
f2 and the skip mask read once, inertia, f1 and f2 written once).  As the
TPU kernel does over VMEM x-slabs, the CUDA kernel runs all of it in one
launch (`tiling.surface_plan`): 32 x 32-thread y-z tiles with a
steps + 1 cell halo march along x and hold every level's newest plane in
shared memory, so only the inputs and the outputs cross device memory.
A launch holds up to `tiling.MAX_LEVELS` blur passes; each further launch
continues the blur from the (f1, f2) pair the one before it wrote
(`_blur` is its plain counterpart).

K5 also covers `surface_fused_2d` (`surface_fused.py:266`), the (x, y)-tiled
form JAX runs for detailed planes above `MAX_PLANE` (the 512^3 detailed
grid of `scaled_scene(256)`): the same stages and order, cut differently
for VMEM.  K5 has no plane limit; tests/test_torch_kernels.py holds the 2D
form against `surface_fused_plain`.

`surface_fused_plain` is the same function in plain PyTorch, with the
kernel's integer formulation and neighbour order (the XLA stages in
`stages/surface_fields.py` add the neighbours in `MOVES` order).

The halo form, `surface_fused_halo_cuda` beside `surface_fused_halo_plain`,
replaces the sharded calls of `surface_fused_pallas` (`halos`, `x0`,
`global_gx`; its halo branch `surface_fused.py:425-435`) and the y-chunk
route of `surface_fused_auto` (`:477-503`) in the x-slab multi-device step.
It runs on the local detailed slab extended by h = steps + 1 neighbour
planes a side; each stage loses one exact ring and values outside the
global domain stay 0, so the interior rows equal the single-device rows.
The card needs no y-chunks: K5 has no plane limit.
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.kernels import build, on_cuda, require, store, tiling
from tpu_fluid_torch.ops.stencil import AXIS_MOVES, div_scalar, neighbor_sum

_ARGTYPES = ((build.POINTER,) * 8 + (build.INT,) * 10
             + (build.FLOAT, build.FLOAT) + (build.INT,) * 5
             + (build.FLOAT, build.POINTER))


def _blur_constants(k: float) -> tuple[float, float]:
    """(1 - 6k, k), computed in double as the JAX kernel's Python floats
    are, and rounded to f32 where they meet the field."""
    return 1.0 - 6.0 * k, k


def _surface(occ, inertia, f2, skip, in_dom, *, steps, k, inc_filled,
             inc_neigh, required_hits, dec, max_inertia, div_coef):
    """Stages 16-18 on a slab; `in_dom` (rows, 1, 1), if given, marks the
    rows inside the global domain, and the signed field and every blur
    pass are 0 outside it."""
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
    if in_dom is not None:
        a = torch.where(in_dom, a, 0.0)
    return (new.to(inertia.dtype),) + _blur(a, f2, skip, in_dom, steps, k)


def _blur(a, b, skip, in_dom, steps, k):
    """`steps` ping-pong blur passes from the pair (a, b), the first
    writing into b; returns the new (a, b).  Cells under a SOLID parent
    keep the value of the buffer a pass writes into."""
    c0, c1 = _blur_constants(k)
    keep = skip != 0
    for it in range(steps):
        src, dst = (a, b) if it % 2 == 0 else (b, a)
        blurred = c0 * src + c1 * neighbor_sum(src, moves=AXIS_MOVES)
        res = torch.where(keep, dst, blurred)
        if in_dom is not None:
            res = torch.where(in_dom, res, 0.0)
        if it % 2 == 0:
            b = res
        else:
            a = res
    return a, b


def surface_fused_plain(occ, inertia, f2, skip, *, steps, k, inc_filled,
                        inc_neigh, required_hits, dec, max_inertia,
                        div_coef, out=None):
    """(inertia', f1', f2'), copied into `out`'s three tensors where
    given."""
    return store(_surface(occ, inertia, f2, skip, None, steps=steps, k=k,
                          inc_filled=inc_filled, inc_neigh=inc_neigh,
                          required_hits=required_hits, dec=dec,
                          max_inertia=max_inertia, div_coef=div_coef), out)


def _extend(fields, halos, h):
    """Each (X, Y, Z) field with its (left, right) h-plane halos."""
    out = []
    for name, a, (left, right) in zip(("occ", "inertia", "f2", "skip"),
                                      fields, halos):
        for side, plane in (("left", left), ("right", right)):
            require(plane, f"{name} {side} halo", a.dtype,
                    (h,) + tuple(a.shape[1:]), a.device)
        out.append(torch.cat([left, a, right]))
    return out


def surface_fused_halo_plain(occ, inertia, f2, skip, *, halos, x0,
                             global_gx, steps, out=None, **kw):
    """The halo form: the arrays are the local detailed slab of global rows
    [x0, x0 + lx), `halos` the ((left, right), ...) h = steps + 1 neighbour
    planes of (occ, inertia, f2, skip), zeros past the domain, and
    `global_gx` the detailed domain's x extent; the results are copied
    into `out`'s three tensors where given."""
    h = steps + 1
    ext = _extend((occ, inertia, f2, skip), halos, h)
    rows = torch.arange(x0 - h, x0 + occ.shape[0] + h, device=occ.device)
    in_dom = ((rows >= 0) & (rows < global_gx)).reshape(-1, 1, 1)
    res = _surface(*ext, in_dom, steps=steps, **kw)
    return store(tuple(a[h:h + occ.shape[0]] for a in res), out)


def _check(occ, inertia, f2, skip, out):
    require(occ, "occ", torch.uint8)
    if occ.ndim != 3:
        raise ValueError(f"occ: shape {tuple(occ.shape)}, expected (X,Y,Z)")
    require(inertia, "inertia", (torch.uint8, torch.int32), occ.shape,
            occ.device)
    require(f2, "f2", torch.float32, occ.shape, occ.device)
    require(skip, "skip", torch.uint8, occ.shape, occ.device)
    if out is None:
        return (None, None, None)
    if len(out) != 3:
        raise ValueError(f"out: {len(out)} tensors, expected (inertia, f1, "
                         f"f2)")
    for name, t, like in zip(("inertia", "f1", "f2"), out,
                             (inertia, f2, f2)):
        if t is not None:
            require(t, f"out {name}", like.dtype, occ.shape, occ.device)
    return out


def device_launches() -> int:
    """Kernels the C entry point of `csrc/surface_fused.cu` has launched."""
    return build.launches("tf_surface_launches")


def _launch(occ, inertia, f2, skip, xb, gx, h, out, *, steps, k,
            inc_filled, inc_neigh, required_hits, dec, max_inertia,
            div_coef):
    """K5 on slabs of nx rows (h halo planes a side, row 0 at global x xb);
    returns the outputs' interior rows, in `out`'s (inertia, f1, f2)
    tensors where given.  The launches of `tiling.surface_plan`: one for
    up to `tiling.MAX_LEVELS` blur passes; the first writes the inertia,
    each one after it continues from the (f1, f2) pair of the one before,
    and the last writes f1 and f2.  An output of rows other than the
    slab's (the halo form's first launch past 8 passes) is copied."""
    nx, gy, gz = occ.shape
    c0, c1 = _blur_constants(k)
    inertia_to, f1_to, f2_to = out

    def output(shape, dtype, given):
        if given is not None and tuple(given.shape) == shape:
            return given
        return torch.empty(shape, dtype=dtype, device=occ.device)

    with torch.cuda.device(occ.device):
        plan = tiling.surface_plan(occ.shape, steps, halo=h,
                                   sms=build.sm_count(occ.device.index))
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        first = plan[0]
        inertia_out = output((first.xe - first.xs, gy, gz), inertia.dtype,
                             inertia_to)
        f1 = None
        x0 = 0  # the slab row that a launch's input row 0 is
        for p in plan:
            out_shape = (p.xe - p.xs, gy, gz)
            last = p is plan[-1]
            f1_out = output(out_shape, f2.dtype, f1_to if last else None)
            f2_out = output(out_shape, f2.dtype, f2_to if last else None)
            build.call("tf_surface_fused", _ARGTYPES, occ.data_ptr(),
                       inertia.data_ptr(), inertia_out.data_ptr(),
                       f1.data_ptr() if f1 is not None else None,
                       f2.data_ptr(), skip.data_ptr() + x0 * gy * gz,
                       f1_out.data_ptr(), f2_out.data_ptr(),
                       inertia.element_size(),
                       p.shape[0], gy, gz, xb + x0, gx, p.xs, p.xe, p.seg,
                       p.levels, c0, c1, inc_filled, inc_neigh,
                       required_hits, dec, max_inertia, div_coef, stream)
            x0 += p.xs
            f1, f2 = f1_out, f2_out
    lo = h - first.xs
    if lo:  # the halo form's first launch wrote rows a later one needed
        inertia_out = inertia_out[lo:lo + nx - 2 * h]
    return store((inertia_out, f1, f2), out)


def surface_fused_cuda(occ, inertia, f2, skip, *, steps, k, inc_filled,
                       inc_neigh, required_hits, dec, max_inertia,
                       div_coef, out=None):
    """K5 wrapper: occ u8, inertia u8 or int32, f2 f32 (the stale buffer)
    and skip u8, all (D,D,D) -> (inertia', f1', f2'), written into `out`'s
    three tensors where given; the CUDA kernel (one launch for up to 8
    blur passes) for CUDA tensors, `surface_fused_plain` for CPU
    tensors."""
    to = _check(occ, inertia, f2, skip, out)
    kw = dict(steps=steps, k=k, inc_filled=inc_filled, inc_neigh=inc_neigh,
              required_hits=required_hits, dec=dec, max_inertia=max_inertia,
              div_coef=div_coef)
    if not on_cuda(occ):
        return surface_fused_plain(occ, inertia, f2, skip, out=out, **kw)
    res = _launch(occ, inertia, f2, skip, 0, occ.shape[0], 0, to, **kw)
    surface_fused_cuda.launches += 1
    return res


surface_fused_cuda.launches = 0


def surface_fused_halo_cuda(occ, inertia, f2, skip, *, halos, x0, global_gx,
                            steps, out=None, **kw):
    """K5 halo-form wrapper (arguments as `surface_fused_halo_plain`): the
    CUDA kernel (one launch for up to 8 blur passes) for CUDA tensors, the
    plain version for CPU tensors.  Past 8 blur passes the first launch
    writes more rows than the slab's, and the inertia's are copied into
    `out`'s."""
    to = _check(occ, inertia, f2, skip, out)
    if not on_cuda(occ):
        return surface_fused_halo_plain(occ, inertia, f2, skip, halos=halos,
                                        x0=x0, global_gx=global_gx,
                                        steps=steps, out=out, **kw)
    h = steps + 1
    ext = _extend((occ, inertia, f2, skip), halos, h)
    res = _launch(*ext, x0 - h, global_gx, h, to, steps=steps, **kw)
    surface_fused_halo_cuda.launches += 1
    return res


surface_fused_halo_cuda.launches = 0
