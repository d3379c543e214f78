"""K1: stage-07 semi-Lagrangian advection of all three MAC components,
with its condition masks taken in.

Replaces `tpu_fluid/kernels/advect.py:advect_all_pallas` (kernel
`_advect_all_kernel`, body `_advect_comps`) and the condition masks JAX
builds before it (`_advect_condition` at
`tpu_fluid/stages/velocity.py:160`); CUDA source `csrc/advect.cu`.  The
TPU kernel sums (2R+1)^3 masked terms over an edge-replicated VMEM slab
because Mosaic cannot gather; the card gathers, so the kernel reads only
the 8 taps that carry weight, in the same ascending order, and agrees
with the masked sum bitwise.  It marches
32 x 32 y-z tiles with an R-cell ring along x (`tiling.grid_fused_pass`
with halo R), keeping the 2R + 1 x planes the face averages and taps reach
in shared memory, so each velocity value is read from device memory about
once; the masks come from the u8 cell types it reads beside them.

K1 also covers two TPU tiling variants of the same function, which differ
only in how they cut VMEM: `advect_one_pallas` (`advect.py:244`), which
JAX runs one component per call for y*z planes above 128^2 (tx = 2 at
256^3), and `advect_component_pallas` (`advect.py:369`), its fallback from
a precomputed displacement field.  K1 indexes with `long long` and has no
plane limit; tests/test_torch_kernels.py holds both variants against
`advect_all_plain` component by component.

`advect_all_plain` is the advection from given masks in plain PyTorch, in
the masked-sum order of `tpu_fluid.stages.velocity.advect_shift`;
`advect_from_types_plain`, the wrapper's plain version, is
`advect_conditions` followed by it.

The halo form, `advect_all_halo_cuda` beside `advect_from_types_halo_plain`,
replaces the sharded calls of `advect_all_pallas` and `advect_one_pallas`
(`halo`, `x0`, `global_shape`; `tpu_fluid/parallel/spmd_step.py:145-177`)
in the x-slab multi-device step: a local slab with its R velocity planes
and one type plane on each side, one launch for all three components.
Clamps and tap indices are global, so a tap never reads the zero planes
past the domain: every row equals the single-device row, at the end shards
too.  JAX's kernels read those zero planes (`_xpad`, `_advect_one_impl`)
where the weight is 0 or the condition is 0, which agrees up to the sign of
a zero.
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.kernels import build, on_cuda, require, tiling
from tpu_fluid_torch.ops.packed_sampler import _edge_shift
from tpu_fluid_torch.ops.stencil import axis_nonzero, shifted

_ARGTYPES = ((build.POINTER,) * 3 + (build.INT,) * 11
             + (build.FLOAT,) * 3 + (build.POINTER,))
# The largest R whose ring of shared planes (2R + 2, rounded up to a power
# of two, 13 KB each) fits a block (csrc/advect.cu).
MAX_RING_R = 7


def advect_condition(types: torch.Tensor, c: int,
                     x0: int = 0) -> torch.Tensor:
    """Advection applies to component c of cell i iff i_c != 0 and cell i
    or its upper neighbour i + e_c is WATER (`advect.comp:66-71`).  On an
    x-slab whose row 0 is global x `x0` the i_x != 0 test is global."""
    water = types == CellType.WATER
    up = tuple(1 if k == c else 0 for k in range(3))
    cond = water | shifted(water, up, fill=False)
    if c == 0:
        ix = torch.arange(x0, x0 + types.shape[0], device=types.device)
        return cond & (ix != 0).reshape(-1, 1, 1)
    return cond & axis_nonzero(types.shape, c, types.device)


def advect_conditions(types: torch.Tensor, x0: int = 0) -> torch.Tensor:
    """The three components' masks as one (3, X, Y, Z) u8 stack."""
    return torch.stack([advect_condition(types, c, x0)
                        for c in range(3)]).to(torch.uint8)


def face_center_velocity(vel: torch.Tensor, c: int) -> torch.Tensor:
    """Full velocity vector at every face centre of component c — the
    first, grid-aligned sample of `advect.comp:74-78`: component c is the
    stored value, each other component c' the 4-point average over
    {i_c-1, i_c} x {i_c', i_c'+1} with clamp-to-edge."""
    comps = []
    for cp in range(3):
        if cp == c:
            comps.append(vel[c])
            continue
        acc = torch.zeros_like(vel[cp])
        for dc in (-1, 0):
            for dcp in (0, 1):
                off = [0, 0, 0]
                off[c] = dc
                off[cp] = dcp
                acc = acc + _edge_shift(vel[cp], tuple(off))
        comps.append(0.25 * acc)
    return torch.stack(comps)


def _x_rows(vel: torch.Tensor, r: int, x0: int, lx: int, xb: int,
            gx: int) -> torch.Tensor:
    """Rows x0 - r .. x0 + lx + r - 1 of the field, each global x clamped
    into [0, gx - 1] and then into `vel` (C, mx, Y, Z), whose row 0 is
    global xb."""
    idx = torch.clamp(torch.arange(x0 - r, x0 + lx + r, device=vel.device),
                      0, gx - 1) - xb
    return vel.index_select(1, torch.clamp(idx, 0, vel.shape[1] - 1))


def _edge_pad_yz(a: torch.Tensor, r: int) -> torch.Tensor:
    """Pad the y and z axes of an (X, Y, Z) field by r with edge
    replication."""
    for ax in (1, 2):
        n = a.shape[ax]
        idx = torch.clamp(torch.arange(-r, n + r, device=a.device), 0, n - 1)
        a = a.index_select(ax, idx)
    return a


def _advect(vx: torch.Tensor, cond3: torch.Tensor, r: int, dt: float,
            x0: int, gx: int) -> torch.Tensor:
    """The masked-sum advection of the rows [x0, x0 + lx) of a domain gx
    wide: `vx` holds those rows with r edge-clamped rows on each side."""
    lx, gy, gz = cond3.shape[1:]
    out = []
    for c in range(3):
        u = -face_center_velocity(vx, c)[:, r:r + lx] * dt
        u = torch.clamp(u, -r, r - 1e-4)
        axes = []
        for d, (n, start) in enumerate(((gx, x0), (gy, 0), (gz, 0))):
            i_d = torch.arange(start, start + cond3.shape[1 + d],
                               dtype=vx.dtype, device=vx.device).reshape(
                tuple(-1 if k == d else 1 for k in range(3)))
            t_d = torch.clamp(i_d + u[d], 0.0, n - 1.0)
            u_d = t_d - i_d
            o_d = torch.floor(u_d)
            f_d = u_d - o_d
            # JAX's (o == delta) * (1 - f): XLA makes the product of a mask
            # a select, so a NaN offset weighs 0, not NaN
            axes.append([torch.where(o_d == delta, 1.0 - f_d, 0.0)
                         + torch.where(o_d == delta - 1, f_d, 0.0)
                         for delta in range(-r, r + 1)])
        wx, wy, wz = axes
        padded = _edge_pad_yz(vx[c], r)
        acc = torch.zeros_like(cond3[c], dtype=vx.dtype)
        for ax, dxo in enumerate(range(-r, r + 1)):
            for ay, dyo in enumerate(range(-r, r + 1)):
                wxy = wx[ax] * wy[ay]
                for az, dzo in enumerate(range(-r, r + 1)):
                    sl = padded[r + dxo:r + dxo + lx,
                                r + dyo:r + dyo + gy,
                                r + dzo:r + dzo + gz]
                    acc = acc + (wxy * wz[az]) * sl
        out.append(torch.where(cond3[c] != 0, acc, vx[c, r:r + lx]))
    return torch.stack(out)


def advect_slab_plain(vel: torch.Tensor, cond3: torch.Tensor, r: int,
                      dt: float, x0: int, global_gx: int) -> torch.Tensor:
    """`advect_all_plain` on a block of global rows [x0, x0 + X) of a
    domain global_gx rows wide: coordinates clamp into the domain, x taps
    into the domain and then into the block."""
    lx = vel.shape[1]
    return _advect(_x_rows(vel, r, x0, lx, x0, global_gx), cond3, r, dt, x0,
                   global_gx)


def advect_all_plain(vel: torch.Tensor, cond3: torch.Tensor, r: int,
                     dt: float) -> torch.Tensor:
    """vel (3,X,Y,Z) f32, cond3 (3,X,Y,Z) u8 -> advected velocity: the
    backtraced point of component c at cell i is t = i - v_face*dt in
    texel space, the displacement clamped to [-R, R-1e-4] and the point to
    the grid, sampled as a hat-weighted sum over all |delta| <= R."""
    return advect_slab_plain(vel, cond3, r, dt, 0, vel.shape[1])


def _halo_slab(vel: torch.Tensor, halo, r: int) -> torch.Tensor:
    left, right = halo
    for name, plane in (("halo[0]", left), ("halo[1]", right)):
        require(plane, name, vel.dtype, (3, r) + tuple(vel.shape[2:]),
                vel.device)
    return torch.cat([left, vel, right], dim=1)


def advect_all_halo_plain(vel: torch.Tensor, cond3: torch.Tensor, r: int,
                          dt: float, halo, x0: int,
                          global_shape) -> torch.Tensor:
    """The halo form: vel and cond3 are the local (3, lx, Y, Z) slab of
    global rows [x0, x0 + lx), `halo` the (left, right) (3, r, Y, Z)
    neighbour planes (zeros past the domain), `global_shape` the domain."""
    gx, lx = global_shape[0], vel.shape[1]
    return _advect(_x_rows(_halo_slab(vel, halo, r), r, x0, lx, x0 - r, gx),
                   cond3, r, dt, x0, gx)


def advect_from_types_plain(vel: torch.Tensor, types: torch.Tensor, r: int,
                            dt: float) -> torch.Tensor:
    """K1's function in plain PyTorch: vel (3,X,Y,Z) f32 and the cell
    types (X,Y,Z) u8 -> the advected velocity, `advect_conditions` then
    `advect_all_plain`."""
    return advect_all_plain(vel, advect_conditions(types), r, dt)


def advect_from_types_halo_plain(vel: torch.Tensor, types_e: torch.Tensor,
                                 r: int, dt: float, halo, x0: int,
                                 global_shape) -> torch.Tensor:
    """The halo form in plain PyTorch: `types_e` (lx + 2, Y, Z) holds the
    slab's types with one neighbour plane a side (zeros past the domain);
    the masks of its inner rows, then `advect_all_halo_plain`."""
    lx = vel.shape[1]
    cond3 = advect_conditions(types_e, x0 - 1)[:, 1:lx + 1].contiguous()
    return advect_all_halo_plain(vel, cond3, r, dt, halo, x0, global_shape)


def _check(vel, types, r, rows):
    require(vel, "vel", torch.float32)
    if vel.ndim != 4 or vel.shape[0] != 3:
        raise ValueError(f"vel: shape {tuple(vel.shape)}, expected (3,X,Y,Z)")
    require(types, "types", torch.uint8, (rows,) + tuple(vel.shape[2:]),
            vel.device)
    if not 1 <= r <= MAX_RING_R:
        raise ValueError(f"advect_max_displacement {r} outside "
                         f"[1, {MAX_RING_R}]")


def _launch(vel_x, types_x, r, dt, gx, x0, lx, xb, tb):
    """K1 on the global rows [x0, x0 + lx), from `vel_x` holding global
    rows [xb, xb + mx) and `types_x` global rows [tb, tb + tn)."""
    _, mx, gy, gz = vel_x.shape
    out = torch.empty((3, lx, gy, gz), dtype=vel_x.dtype,
                      device=vel_x.device)
    p = tiling.grid_fused_pass((mx, gy, gz), r, slab_halo=x0 - xb,
                               sms=build.sm_count(vel_x.device.index))
    assert p.xe - p.xs == lx
    with torch.cuda.device(vel_x.device):
        stream = torch.cuda.current_stream(vel_x.device).cuda_stream
        build.call("tf_advect_all", _ARGTYPES, vel_x.data_ptr(),
                   types_x.data_ptr(), out.data_ptr(), gx, gy, gz, xb, mx,
                   tb, types_x.shape[0], x0, lx, p.seg, r, dt, float(-r),
                   r - 1e-4, stream)
    return out


def advect_all_cuda(vel: torch.Tensor, types: torch.Tensor, r: int,
                    dt: float) -> torch.Tensor:
    """K1 wrapper: vel (3,X,Y,Z) f32, the cell types (X,Y,Z) u8 -> the
    advected velocity; the CUDA kernel for CUDA tensors,
    `advect_from_types_plain` for CPU tensors."""
    _check(vel, types, r, vel.shape[1])
    if not on_cuda(vel):
        return advect_from_types_plain(vel, types, r, dt)
    gx = vel.shape[1]
    out = _launch(vel, types, r, dt, gx, 0, gx, 0, 0)
    advect_all_cuda.launches += 1
    return out


advect_all_cuda.launches = 0


def advect_all_halo_cuda(vel: torch.Tensor, types_e: torch.Tensor, r: int,
                         dt: float, halo, x0: int,
                         global_shape) -> torch.Tensor:
    """K1 halo-form wrapper (arguments as `advect_from_types_halo_plain`):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    lx = vel.shape[1]
    _check(vel, types_e, r, lx + 2)
    if tuple(global_shape[1:]) != tuple(vel.shape[2:]) or not (
            0 <= x0 and x0 + lx <= global_shape[0]):
        raise ValueError(f"global_shape {tuple(global_shape)} does not fit "
                         f"the slab {tuple(vel.shape)} at x0={x0}")
    if not on_cuda(vel):
        return advect_from_types_halo_plain(vel, types_e, r, dt, halo, x0,
                                            global_shape)
    out = _launch(_halo_slab(vel, halo, r), types_e, r, dt, global_shape[0],
                  x0, lx, x0 - r, x0 - 1)
    advect_all_halo_cuda.launches += 1
    return out


advect_all_halo_cuda.launches = 0
